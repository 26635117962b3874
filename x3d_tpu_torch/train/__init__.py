"""Training: LR schedule, optimizer and state, train and eval steps, the
multigrid schedule and loop."""

from x3d_tpu_torch.train.schedule import (  # noqa: F401
    lr_for_epoch,
    make_lr_schedule,
)
from x3d_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
)
from x3d_tpu_torch.train.multigrid import (  # noqa: F401
    MultigridSchedule,
    fit_multigrid,
    make_bn_recalibrator,
)
from x3d_tpu_torch.train.steps import (  # noqa: F401
    l2_penalty,
    make_eval_step,
    make_train_step,
)
