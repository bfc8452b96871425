"""Helpers of the readers of the program's own span records
(``xpysom_dask_tpu_torch.utils.profiling.recorded()``). The program keeps
records only while a profiler runs, so in a ``--trace 1`` run they are
the traced window's calls; a program without them (an older one) gives
none, and its readers read nothing. Rank 0's records, where the readers
run."""

# the program's call spans (each a call's outermost record) that a part
# of a metric's name stands for
ROOTS = {"train": ("xpysom.train",),
         "score": ("xpysom.quantization_error", "xpysom.topographic_error"),
         "predict": ("xpysom.predict",)}


def records() -> list:
    """The closed span records the program kept in this process; [] where
    the program keeps none."""
    try:
        from xpysom_dask_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return []
    return [r for r in recorded()[0] if r.get("t1") is not None]


def calls(part):
    """The program's calls that ``part`` names, each as ``(its call span,
    the records of its steps)``: the records that share the call span's
    ``call`` id. None where the program recorded none."""
    recs = records()
    roots = {r["id"]: (r, []) for r in recs if r["call"] == r["id"] and r["name"] in ROOTS[part]}
    if not roots:
        return None
    for r in recs:
        if r["call"] != r["id"] and r["call"] in roots:
            roots[r["call"]][1].append(r)
    return list(roots.values())


def named(recs, name):
    return [r for r in recs if r["name"] == name]
