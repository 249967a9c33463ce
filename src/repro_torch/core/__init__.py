"""TinyTrain core: Fisher probe, Eq. 3 selection, sparse fine-tune, and the
host-sync telemetry shared by the adaptation and serving engines."""
from .policy import SparseUpdatePolicy, SelectedUnit, full_policy, last_layer_policy  # noqa: F401
from .criterion import Budget, UnitCost, multi_objective_scores  # noqa: F401
from .selection import select_policy, static_channel_policy, topk_channels  # noqa: F401
from .fisher import fisher_probe, fisher_from_activations  # noqa: F401
from .sparse import make_sparse_train_step, make_episode_sparse_step, sparse_memory_report  # noqa: F401
from .backbones import Backbone, lm_backbone, cnn_backbone  # noqa: F401
from .adapt import adapt_task, evaluate_task, AdaptResult  # noqa: F401
from .session import (  # noqa: F401
    Adaptation, DeviceProfile, Task, TinyTrainSession, device_profile,
    register_criterion, register_profile,
)
from . import protonet, baselines  # noqa: F401
