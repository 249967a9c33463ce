"""One driver a kind of traffic (the mix's ``kind``): ``run(ctx)`` builds
the program's object from the benchmark's inputs, warms it, measures the
window, judges the outputs and returns the run's record."""
