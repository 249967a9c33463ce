"""A whole run of the adaptation driver at smoke size on the CPU, past the harness's
look for a card: the result's line, and ``correct`` false under each
fault the cell can have, planted in the program underneath."""
import contextlib
import io
import json
from unittest import mock

import pytest
import torch
import pb_smoke
from pb_smoke import MAMBA2_SMOKE, ZAMBA2_SMOKE

from port_bench import bench
from port_bench.drivers import adapt as DA


def _line(ctx, rec, workload):
    b = bench.spec()
    ctx.workload = workload
    out, err = io.StringIO(), io.StringIO()
    # a test process may hold the JAX package from other tests; the guard
    # itself is tested in test_pb_imports
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            mock.patch.object(bench, "forbidden_modules", lambda: []):
        rc = bench.finish(ctx, rec, b)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return line


def _adapt(arch, trace=False, dtype="float32"):
    with pb_smoke.one_thread():
        ctx = pb_smoke.context(arch, pb_smoke.small_adapt_mix(),
                               pb_smoke.ADAPT_LIMITS, trace=trace,
                               dtype=dtype)
        return ctx, DA.run(ctx)


@pytest.mark.parametrize("arch", [MAMBA2_SMOKE, ZAMBA2_SMOKE],
                         ids=lambda a: a["name"])
def test_adapt_run_line(arch):
    ctx, rec = _adapt(arch)
    line = _line(ctx, rec, "mamba2-1.3b.adapt")
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(rec["tasks"]) >= 1
    m = line["metrics"]
    assert set(m) == {"adapt_tasks_per_s", "setup_s"}  # no card memory
    assert m["adapt_tasks_per_s"]["unit"] == "tasks/s"
    assert line["device"]["memory_peak_bytes"] == 0
    assert set(line["checks"]) == set(pb_smoke.ADAPT_LIMITS)


def test_adapt_traced_line():
    ctx, rec = _adapt(MAMBA2_SMOKE, trace=True)
    line = _line(ctx, rec, "mamba2-1.3b.adapt")
    assert line["correct"] is True
    # the CPU trace has no device operation: the device readers return
    # nothing, the host counters still read
    want = {"launches_per_task"}
    if len(rec["tasks"]) > 1:  # the spans of the untraced tasks
        want |= {"probe_s", "finetune_s"}
    assert set(line["metrics"]) == want
    assert "breakdown" in line and line["device"]["window_s"] > 0


def test_planted_bf16_program_fails():
    """The program in bfloat16 against the float32 reference, held to the
    float32 program's limits."""
    ctx, rec = _adapt(MAMBA2_SMOKE, dtype="bfloat16")
    assert _line(ctx, rec, "mamba2-1.3b.adapt")["correct"] is False


def test_fault_state_unchanged(monkeypatch):
    """A fine-tune step that returns its state as it came."""
    from repro_torch.core import sparse

    monkeypatch.setattr(sparse, "apply_updates", lambda x, u: x)
    ctx, rec = _adapt(MAMBA2_SMOKE)
    assert rec["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert _line(ctx, rec, "mamba2-1.3b.adapt")["correct"] is False


def test_fault_half_the_batch(monkeypatch):
    """The loss's mean taken over half of the query rows."""
    from repro_torch.core import protonet

    ce = protonet._cross_entropy

    def half(logits, labels):
        labels = labels.clone()
        labels[labels.shape[0] // 2:] = -1
        return ce(logits, labels)

    monkeypatch.setattr(protonet, "_cross_entropy", half)
    ctx, rec = _adapt(ZAMBA2_SMOKE)
    assert _line(ctx, rec, "mamba2-1.3b.adapt")["correct"] is False


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = bench.main(["--workload", "mamba2-1.3b.adapt", "--seed", "1",
                     "--seconds", "1", "--trace", "0"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "NVIDIA" in out.err


def test_calibration_judges_each_side(monkeypatch, tmp_path):
    """calibrate.py's readings at smoke size: the program passes the smoke
    limits, the e4m3 control and the half-batch fault each come out not
    correct under the harness's own judge, and a recorded line judges
    the same again."""
    import json

    from port_bench import calibrate

    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    with pb_smoke.one_thread():
        ctx = pb_smoke.context(MAMBA2_SMOKE, pb_smoke.small_adapt_mix(), {})
        rec = calibrate.adapt_seed(ctx, True)
    assert len(rec["losses"]["program"]) == ctx.mix["iters"]
    assert calibrate.verdicts(rec, pb_smoke.ADAPT_LIMITS) == {
        "program": True, "control": False, "half_batch": False}
    assert set(calibrate.verdicts({"program": rec["program"]},
                                  pb_smoke.ADAPT_LIMITS)) == {"program"}
    path = tmp_path / "cal.jsonl"
    path.write_text(json.dumps(dict(rec, seed=1)) + "\n")
    monkeypatch.setattr(bench, "limits_for", lambda w: pb_smoke.ADAPT_LIMITS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert calibrate.main(["--workload", "mamba2-1.3b.adapt",
                               "--rejudge", str(path)]) == 0
    assert json.loads(out.getvalue())["correct"]["control"] is False
