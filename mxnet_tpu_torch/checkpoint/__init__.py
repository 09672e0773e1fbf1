"""mxnet_tpu_torch.checkpoint — fault-tolerant training checkpoints
(counterpart of mxnet_tpu/checkpoint).

Atomic commits that survive ``kill -9`` at any instant, the complete
training state (parameters, optimizer states with the fp32 masters, the
fp16 loss scaler, the random state, the epoch/batch cursor),
asynchronous saves that overlap training, retention and resume. Commits
are sharded (per-shard checksummed manifests and a TOPOLOGY.json seal
written last), and a restore reassembles the arrays for any shard count.
The JAX package restores the port's commits and the port the JAX
package's (``state.py`` says what crosses).

    mod.fit(it, num_epoch=20, checkpoint_dir="ckpt", resume=True)
        # a commit at every epoch end; after a preemption the same call
        # restores the newest commit and continues bit-identically

    mgr = CheckpointManager("ckpt", keep_last_n=3, keep_best_k=1)
    mgr.save(capture_module_state(mod, epoch=5), step=500, metric=acc)
    state = mgr.restore()

    python -m mxnet_tpu_torch.checkpoint --selftest
        # SIGKILL in the middle of a save, restore, bit-identical resume
"""
from .manager import CheckpointManager, last_sealed_commit
from .state import (TrainingState, capture_module_state,
                    capture_trainer_state, restore_module_state,
                    restore_trainer_state, rescale_cursor, state_sha256)

__all__ = ["CheckpointManager", "TrainingState", "capture_module_state",
           "capture_trainer_state", "restore_module_state",
           "restore_trainer_state", "rescale_cursor", "state_sha256",
           "last_sealed_commit"]
