"""One rank of the port's data-parallel UNet step, for
tests/test_torch_parallel.py (not a test module):

    python tests/torch_ddp_worker.py OUT_DIR   # MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK set

Joins the gloo group through ``parallel.init_multihost``, then runs
:func:`step` twice: with the BatchNorm's global statistics (what the trainer
sets under DDP) and with each rank's own. Each rank saves its results to
``OUT_DIR/rank<R>.pt``. Imports no JAX.
"""

import os
import sys

import torch

from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.models.unet import FlaxBatchNorm2d
from musicfpaugment_torch.train.trainer import Trainer

SR = 8000
GLOBAL_BATCH = 16  # 8 a rank on 2 ranks: the CPU augmenter is batch-invariant at multiples of 8
SEED = 5


def batches():
    """(train clean batch, validation clean batch), float64, the same on
    every rank."""
    train, val = (next(synthetic_clean_batches(GLOBAL_BATCH, SR, SR, seed=s)) for s in (9, 10))
    return torch.from_numpy(train).double(), val


def step(ckpt: str, global_bn: bool = True) -> dict:
    """One training step of a float64 ``UNet(base=8, rate=0.05)`` on the
    global batch (this process's share of it under a process group: its
    slice of the global dropout masks too), augmented on the CPU, then one
    validation epoch: the loss terms, the gradients, the
    parameters and running statistics after the step, the validation
    losses and PSNR."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    model = UNet(1, 1, rate=0.05, base=8).double()
    nb, ib = synthetic_banks(sample_rate=SR, noise_row_length=SR, device="cpu")
    fp = AugmentFP(nb, SR, impulse_response_dir=ib, device="cpu")
    train, val = batches()
    trainer = Trainer(model, iter(()), 1, iter([val]), 1, 1e-3, 2, ckpt, input_type="spec",
                      augmenter=fp, seed=SEED, device="cpu")
    if not global_bn:
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm2d):
                m.distributed = False
    terms = trainer.train_step(train)
    val_losses, metrics = trainer.validation_epoch()
    return {
        "loss": float(terms["loss"]),
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "state": {k: v.clone() for k, v in model.state_dict().items()},
        "val": val_losses, "metrics": metrics, "ddp": type(trainer._train_model).__name__,
    }


def main(out_dir: str) -> None:
    import torch.distributed as dist

    from musicfpaugment_torch.parallel import init_multihost

    rank = init_multihost(device="cpu")
    try:
        results = {
            "global_bn": step(os.path.join(out_dir, f"ckpt{rank}")),
            "rank_bn": step(os.path.join(out_dir, f"ckpt{rank}b"), global_bn=False),
            "world": dist.get_world_size(),
        }
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
