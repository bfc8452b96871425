"""The comparison that decides ``correct``: the program's outputs from the
window, judged by the plain reference (``reference/som.py``), which
works everything out again from the inputs the benchmark made.

Fit jobs. The batch SOM is chaotic over many epochs: the program's
float32 search and the exact search resolve near-ties differently, and
twenty epochs grow those few flips into maps that differ by a few
percent while being equally good, so the reference cannot follow the
whole job from the initial codebook. It follows the program step by
step instead, from the program's own codebooks: after the window the
harness runs the same ``train(X, epochs, iter_beg, iter_end)`` entry in
segments (segmented training equals the whole call bit for bit), and
the reference recomputes the epochs that the configuration's
``checked_epochs`` names (``first``, ``middle``, ``last``; all three
where it names none) from the program's codebook before each. The
numbers:

- ``step_gap``: over those epochs, the largest distance between a
  unit's code vector after the program's epoch and after the
  reference's, over the median norm of the reference's code vectors;
- ``rerun_apart``: 1 where the segments' last codebook differs in any
  bit from the window's last ``train`` call's, else 0;
- ``qe_gap``: the last job's quantization error against the reference's
  on the program's codebook, relative;
- ``te_gap``: the last job's topographic error against the reference's
  on the program's codebook, absolute (a share of the rows);
- ``ranks_apart`` (a mesh): the ranks whose codebook differs in any bit
  from rank 0's.

Predict requests: ``winner_gap``, over the rows of the requests the
check keeps, the most by which a returned unit lies farther from its row
than the nearest unit, in squared euclidean units (float64).
"""

from __future__ import annotations

import numpy as np

__all__ = ["EPOCHS", "checked_epochs", "segment_marks", "fit_numbers", "predict_numbers", "verdict"]

EPOCHS = ("first", "middle", "last")


def checked_epochs(epochs: int, which=EPOCHS) -> list:
    """The epochs the reference recomputes, by name (``which``)."""
    at = {"first": 0, "middle": epochs // 2, "last": epochs - 1}
    return sorted({at[w] for w in which})


def segment_marks(epochs: int, which=EPOCHS) -> list:
    """Where the program's segmented re-run stops: before and after each
    checked epoch, and at the end."""
    return sorted({0, epochs} | {m for t in checked_epochs(epochs, which) for m in (t, t + 1)})


def _f64(torch, device, w):
    return torch.from_numpy(np.asarray(w, dtype=np.float32)).to(device).double()


def fit_numbers(torch, ref, cfg, device, X, epochs, states, final, qe, te, which=EPOCHS):
    """The fit job's numbers. ``states``: the program's codebooks at each
    of :func:`segment_marks`; ``final``, ``qe``, ``te``: the window's last
    job's outputs; ``which``: the checked epochs' names."""
    Xd = torch.from_numpy(X).to(device)
    gaps, medians = [], []
    for t in checked_epochs(epochs, which):
        want = ref.step(cfg, Xd, _f64(torch, device, states[t]), t, epochs)
        node = (_f64(torch, device, states[t + 1]).reshape(want.shape) - want)
        node = node.reshape(-1, cfg.input_len).norm(dim=1)
        scale = want.reshape(-1, cfg.input_len).norm(dim=1).median()
        gaps.append(float(node.max() / scale))
        medians.append(float(node.median() / scale))
    wp = _f64(torch, device, final)
    qe_r = ref.quantization_error(Xd, wp)
    te_r = ref.topographic_error(Xd, wp, cfg.y)
    same = np.array_equal(np.asarray(states[epochs], dtype=np.float32).view(np.int32),
                          np.asarray(final, dtype=np.float32).view(np.int32))
    return {
        "step_gap": max(gaps),
        "step_gap_median": max(medians),
        "rerun_apart": 0 if same else 1,
        "qe_gap": abs(float(qe) - qe_r) / qe_r,
        "te_gap": abs(float(te) - te_r),
    }


def predict_numbers(torch, ref, cfg, device, pool, w0, kept):
    """``kept``: ``(offset, rows, winners)`` of the requests the check
    compares."""
    if not kept:
        return {"winner_gap": float("inf")}
    idx = np.concatenate([np.arange(o, o + n) for o, n, _ in kept])
    got = np.concatenate([np.asarray(w, dtype=np.int64).reshape(-1) for _, _, w in kept])
    if got.shape[0] != idx.shape[0]:
        return {"winner_gap": float("inf")}
    rows = torch.from_numpy(pool[idx]).to(device)
    gaps = ref.winner_gaps(rows, torch.from_numpy(w0).to(device), torch.from_numpy(got).to(device),
                           cfg.activation)
    return {"winner_gap": float(gaps.max())}


def verdict(numbers: dict, limits: dict):
    """``(correct, compared)``: every number with a limit must be at or
    under it (a NaN fails); ``compared`` maps each to its value and
    limit."""
    compared = {k: {"value": numbers.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared
