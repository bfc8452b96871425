"""Checkpoint / serialization (counterpart of
``xpysom_dask_tpu/utils/serialization.py``).

Two mechanisms, as in the JAX package: whole-object pickle, whose
``XPySom.__getstate__`` keeps the device as the caller gave it and
resolves it again on the loading host, and a portable on-disk checkpoint
— a single ``.npz`` with the codebook, the RNG state and a JSON header of
constructor parameters — for per-epoch fault tolerance on long runs.

The ``.npz`` layout and header are the JAX package's, format 1, so a
checkpoint written by either package loads in the other: the header
carries ``use_pallas`` (the port's ``use_kernels`` when it was explicit,
else null) and ``bmu_tiles`` (always null: the port's kernels take no
tiles); on load ``use_pallas`` maps to ``use_kernels`` and ``bmu_tiles`` is
ignored. A population checkpoint (:func:`save_population_checkpoint`)
holds the stacked (P, X, Y, D) codebooks, every member's RNG state and
config, in the same format and with the JAX package's header.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

__all__ = [
    "save",
    "load",
    "save_checkpoint",
    "load_checkpoint",
    "save_population_checkpoint",
    "load_population_checkpoint",
]

_FORMAT_VERSION = 1


def _norm_path(path) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize both save
    and load to the same name so the documented save->resume round-trip
    works for any path."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _should_write() -> bool:
    """In a multi-process run every process holds the same model state, so
    only rank 0 writes the checkpoint — concurrent np.savez calls on one
    shared-filesystem path would interleave and corrupt the zip exactly
    when fault tolerance is needed."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _atomic_savez(path: str, **arrays) -> None:
    """Write to a temp name then os.replace: a crash (or a concurrent
    reader) mid-write must never leave a truncated checkpoint at the
    final path — the previous complete checkpoint survives."""
    tmp = path + f".tmp.{os.getpid()}"
    try:
        np.savez(tmp, **arrays)
        # np.savez appends .npz to extension-less names
        tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(tmp_real, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            try:
                os.remove(cand)
            except OSError:
                pass
        raise


def save(som, path):
    """Pickle convenience (the reference's pickle usage)."""
    with open(path, "wb") as f:
        pickle.dump(som, f)


def load(path):
    """Unpickle a model written by :func:`save` (only load files this
    program wrote: unpickling can run arbitrary code)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _config_dict(som):
    return {
        "x": som._x,
        "y": som._y,
        "input_len": som._input_len,
        "sigma": float(som._sigma),
        "sigmaN": float(som._sigmaN),
        "learning_rate": float(som._learning_rate),
        "learning_rateN": float(som._learning_rateN),
        "decay_function": som._decay_function_name,
        "neighborhood_function": som.neighborhood_func_name,
        "std_coeff": float(som._std_coeff),
        "topology": som.topology,
        "activation_distance": som._activation_distance_name,
        "activation_distance_kwargs": som._activation_distance_kwargs,
        "compact_support": bool(som.compact_support),
        # 0 = auto-sized: persisting the resolved value would make the
        # loader treat it as explicit and size the loading host's chunks
        # by the saving host's device
        "n_parallel": int(som._n_parallel) if som._n_parallel_explicit else 0,
        # numeric semantics: always travels, so the reloaded model
        # reproduces the training numerics
        "bmu_precision": som._bmu_precision,
        # hardware choices: only when explicit, so the loading host's
        # XPYSOM_TPU_NO_PALLAS switch is honored
        "bmu_tiles": None,
        "use_pallas": bool(som._use_kernels) if som._use_kernels_explicit else None,
    }


def save_checkpoint(som, path, *, epoch=None):
    """Write a portable checkpoint: codebook + RNG state + config header.

    ``epoch`` (optional) records how many epochs of the current schedule
    have completed, so training can resume with
    ``train(data, T, iter_beg=epoch)``.
    """
    if not _should_write():
        return
    path = _norm_path(path)
    header = {
        "format_version": _FORMAT_VERSION,
        "config": _config_dict(som),
        "epoch": epoch,
    }
    rng_state = som._random_generator.get_state()
    _atomic_savez(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        weights=np.asarray(som._weights),
        rng_keys=np.asarray(rng_state[1]),
        rng_meta=np.asarray([rng_state[2], rng_state[3], 0], dtype=np.float64),  # pos, has_gauss, pad
        rng_gauss=np.asarray([rng_state[4]], dtype=np.float64),
    )


def load_checkpoint(path, *, device=None):
    """Rebuild an ``XPySom`` from a checkpoint of either package. ``device``
    is where the model runs on the loading host (default: the card) —
    hardware is a property of the host, not of the checkpoint."""
    from ..models.som import XPySom

    with np.load(_norm_path(path)) as z:
        if "header" not in z.files or "weights" not in z.files:
            raise ValueError(
                f"{path!r} is not an xpysom checkpoint "
                f"(missing header/weights entries; found {z.files})"
            )
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} is newer than "
                f"this library supports ({_FORMAT_VERSION})"
            )
        cfg = header["config"]
        som = XPySom(
            cfg["x"],
            cfg["y"],
            cfg["input_len"],
            sigma=cfg["sigma"],
            sigmaN=cfg["sigmaN"],
            learning_rate=cfg["learning_rate"],
            learning_rateN=cfg["learning_rateN"],
            decay_function=cfg["decay_function"],
            neighborhood_function=cfg["neighborhood_function"],
            std_coeff=cfg["std_coeff"],
            topology=cfg["topology"],
            activation_distance=cfg["activation_distance"],
            activation_distance_kwargs=cfg["activation_distance_kwargs"],
            compact_support=cfg["compact_support"],
            n_parallel=cfg["n_parallel"],
            device=device,
            # absent in format-1 checkpoints written before the kernel
            # config was stored: fresh resolution
            bmu_precision=cfg.get("bmu_precision"),
            use_kernels=cfg.get("use_pallas"),
        )
        w = np.asarray(z["weights"])
        expect = (cfg["x"], cfg["y"], cfg["input_len"])
        if w.shape != expect:
            raise ValueError(
                f"checkpoint weights shape {w.shape} does not match its "
                f"own config {expect} — corrupt or hand-edited file"
            )
        som._weights = w
        som._random_generator.set_state(
            (
                "MT19937",
                np.asarray(z["rng_keys"], dtype=np.uint32),
                int(z["rng_meta"][0]),
                int(z["rng_meta"][1]),
                float(z["rng_gauss"][0]),
            )
        )
        # 0 when the checkpoint was saved without epoch=, so the resume
        # recipe train(..., iter_beg=ckpt._checkpoint_epoch) never sees None
        epoch = header.get("epoch")
        som._checkpoint_epoch = 0 if epoch is None else int(epoch)
    return som


def _rng_arrays(rng_states):
    """Stack MT19937 states into three arrays (keys/meta/gauss)."""
    keys = np.stack([np.asarray(s[1], dtype=np.uint32) for s in rng_states])
    meta = np.asarray([[s[2], s[3], 0] for s in rng_states], dtype=np.float64)
    gauss = np.asarray([s[4] for s in rng_states], dtype=np.float64)
    return keys, meta, gauss


def save_population_checkpoint(pop, path, *, epoch=None):
    """One portable ``.npz`` for a whole ``SomPopulation``: the stacked
    (P, X, Y, D) codebooks, every member's RNG state and a header with each
    member's config — the population's :func:`save_checkpoint`."""
    if not _should_write():
        return
    path = _norm_path(path)
    header = {
        "format_version": _FORMAT_VERSION,
        "population": {
            "n_members": pop.n_members,
            # 0 = auto-sized, as for a single model's n_parallel
            "n_parallel": int(pop._n_parallel) if pop._n_parallel_explicit else 0,
            "configs": [_config_dict(m) for m in pop.members],
        },
        "epoch": epoch,
    }
    keys, meta, gauss = _rng_arrays([m._random_generator.get_state() for m in pop.members])
    _atomic_savez(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        weights=np.ascontiguousarray(pop.weights),
        rng_keys=keys,
        rng_meta=meta,
        rng_gauss=gauss,
    )


def load_population_checkpoint(path, *, device=None):
    """Rebuild a ``SomPopulation`` from a population checkpoint of either
    package, on ``device`` (default: the card)."""
    from ..models.population import SomPopulation

    with np.load(_norm_path(path)) as z:
        if "header" not in z.files or "weights" not in z.files:
            raise ValueError(
                f"{path!r} is not an xpysom checkpoint "
                f"(missing header/weights entries; found {z.files})"
            )
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} is newer than "
                f"this library supports ({_FORMAT_VERSION})"
            )
        if "population" not in header:
            raise ValueError(f"{path!r} is a single-model checkpoint — use load_checkpoint")
        meta_hdr = header["population"]
        cfgs = meta_hdr["configs"]
        p = int(meta_hdr["n_members"])
        if len(cfgs) != p:
            raise ValueError(
                f"corrupt population checkpoint: {len(cfgs)} member configs for n_members={p}"
            )
        c0 = cfgs[0]
        pop = SomPopulation(
            p,
            c0["x"],
            c0["y"],
            c0["input_len"],
            sigma=[c["sigma"] for c in cfgs],
            sigmaN=[c["sigmaN"] for c in cfgs],
            learning_rate=[c["learning_rate"] for c in cfgs],
            learning_rateN=[c["learning_rateN"] for c in cfgs],
            decay_function=c0["decay_function"],
            neighborhood_function=c0["neighborhood_function"],
            std_coeff=c0["std_coeff"],
            topology=c0["topology"],
            activation_distance=c0["activation_distance"],
            activation_distance_kwargs=c0["activation_distance_kwargs"],
            compact_support=c0["compact_support"],
            n_parallel=meta_hdr.get("n_parallel", 0),
            device=device,
        )
        w = np.asarray(z["weights"])
        expect = (p, c0["x"], c0["y"], c0["input_len"])
        if w.shape != expect:
            raise ValueError(
                f"checkpoint weights shape {w.shape} does not match its "
                f"own config {expect} — corrupt or hand-edited file"
            )
        keys = np.asarray(z["rng_keys"], dtype=np.uint32)
        meta = np.asarray(z["rng_meta"])
        gauss = np.asarray(z["rng_gauss"])
        for i, (m, c) in enumerate(zip(pop.members, cfgs)):
            m._weights = w[i].copy()
            # the kernel config as load_checkpoint restores it: the numeric
            # mode travels (a resumed sweep searches as the earlier epochs
            # did), use_kernels only where it was explicit
            if c.get("bmu_precision"):
                m._bmu_precision = c["bmu_precision"]
            if c.get("use_pallas") is not None:
                m._use_kernels = bool(c["use_pallas"])
                m._use_kernels_explicit = True
            m._random_generator.set_state(
                ("MT19937", keys[i], int(meta[i][0]), int(meta[i][1]), float(gauss[i]))
            )
        epoch = header.get("epoch")
        pop._checkpoint_epoch = 0 if epoch is None else int(epoch)
    return pop
