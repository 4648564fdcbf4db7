"""Training support of the port: checkpoints (``checkpoint.py``), the
step profiler (``profiler.py``) and gradient sync (``collective.py``:
DDP and ZeRO-1 over a process group). The trainer, its controller and
TrainContext come with the runtime copy, ROADMAP.md Queue 1 item 9; the
training step itself is ``ray_tpu_torch.scripts.bench_train``'s."""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    load_pytree,
    load_sharded_state,
    reshard_states,
    save_pytree,
    save_sharded_state,
)

__all__ = ["Checkpoint", "load_pytree", "load_sharded_state",
           "reshard_states", "save_pytree", "save_sharded_state"]
