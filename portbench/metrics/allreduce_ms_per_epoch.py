"""Device time of NCCL kernels in the traced ``train`` calls per epoch
trained, on the slowest rank. None where no NCCL kernel ran."""

from _common import calls


def read(ctx, part):
    per_rank = calls(ctx, "train")
    if not per_rank or not per_rank[0]:
        return None
    epochs = sum(s["epochs"] for s in ctx.spans[0] if s["kind"] == "train")
    worst = max(sum(c["nccl_s"] for c in rank) for rank in per_rank)
    return 1e3 * worst / epochs if worst > 0 else None
