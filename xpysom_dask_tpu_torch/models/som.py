"""MiniSom/XPySom-compatible batch SOM model on the PyTorch core.

Counterpart of ``xpysom_dask_tpu/models/som.py``: the same constructor
surface and the same training and scoring methods, on PyTorch tensors.
``bmu_tiles=`` and ``use_pallas=`` give way to ``device=`` and
``use_kernels=``; ``xp=`` and ``dask_chunks=`` are accepted and ignored.
The codebook lives on the host as a numpy array (``get_weights()``),
initialized from numpy's ``RandomState(random_seed)`` exactly as the JAX
package does, so the same seed gives the same initial codebook.

This port serves every activation of the JAX package (euclidean, cosine,
manhattan, norm_p with any p, and the ``_no_opt`` names) on rectangular
and hexagonal grids, in every precision mode (``'packed'``, ``'bf16'``,
``'split2'``, ``'split3'``, ``'highest'``, ``'margin'``), and the analysis
methods (``activate``, ``distance_from_weights``, ``quantization``,
``distance_map``, ``activation_response``, ``win_map``, ``labels_map``,
the coordinate helpers), checkpoints (``save_checkpoint``,
``load_checkpoint``, ``train(checkpoint_path=, checkpoint_every=)``) in
the JAX package's ``.npz`` format, pickling, ``verbose`` progress,
``get_neig_functions`` and ``autotune_kernel``. Source-like data (a
``parallel.pipeline`` DataSource or an ``np.memmap``) streams through the
card in superbatches in ``train``, ``predict``, ``quantization_error``,
``topographic_error`` and ``activation_response``.

Data parallel (``mesh=``, ``use_dask=True``): one process per card,
joined by ``torch.distributed`` (``parallel.mesh``). Each rank trains on
its block of the chunks and updates from the statistics all_reduced once
an epoch, so every rank holds the same codebook; ``winner``/``predict``
gather every rank's winners, QE and TE reduce their sums. Every rank must
make the same calls with the same resident data; a streamed source is
each rank's own (training only).

Codebook sharding (``mesh=`` a (data, model) grid: ``make_grid_mesh``, a
``(n_data, n_model)`` pair or a ``DeviceMesh`` named ``('data',
'model')``): ``n_data × n_model`` processes, one a card. Each rank holds
its X-slice of the codebook and the chunks of its data index
(``parallel.grid_sharded``); training, ``winner``/``predict``, QE, TE
(on one device where a shard would hold fewer than two rows), streamed
training and checkpoints run over it, and every rank ends ``train`` with
the full codebook, gathered over its model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import Counter, defaultdict
from typing import NamedTuple, Optional
from warnings import warn

import numpy as np
import torch

from .. import core
from ..core import SomSpec
from ..ops import kernels
from ..ops.decays import DECAY_REGISTRY
from ..ops.distances import DistanceFunction, euclidean_distance, manhattan_distance_no_opt
from ..parallel import grid_sharded
from ..parallel.mesh import (
    GridMesh,
    fetch_global,
    mesh_spans_processes,
    resolve_mesh,
)
from ..parallel.pipeline import (
    ArraySource,
    _feed,
    default_superbatch_rows,
    device_superbatches,
    train_streaming,
)
from ..utils import serialization
from ..utils.hw import default_n_parallel, resolve_device, round_up, training_chunk
from ..utils.profiling import annotate
from ..utils.progress import ProgressReporter

__all__ = ["XPySom", "TuneResult"]

_RECT_NEIGS = ("gaussian", "mexican_hat", "bubble", "triangle")
_HEX_NEIGS = ("gaussian", "mexican_hat", "bubble")


def _chunks_on(data2d: np.ndarray, chunk: int, mesh, device):
    """``core.chunk_data``'s (C, chunk, D) chunks, (C, chunk) float32 mask
    and row count, made on ``device`` by the pipeline's feed
    (``pipeline._feed``: the caller's rows copied straight into the padded
    chunks, no padded copy on the host). With a mesh, the chunk count
    padded to a multiple of the world size (the last rank's extra chunks
    fully masked: their statistics are exact zeros) and only this rank's
    block, of its rows alone, on the rank's device. Over a grid the blocks
    are the data indices': every rank of a model group gets the same
    one."""
    if isinstance(mesh, GridMesh):
        mesh = mesh.data
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    n, d = data2d.shape
    with annotate("xpysom.prepare", rows=n) as span:
        c = round_up(max(1, -(-n // chunk)), world) // world  # chunks a rank
        span.add(padded_rows=c * chunk * world)
    per = c * chunk
    lo, hi = min(n, rank * per), min(n, (rank + 1) * per)
    if mesh is not None:
        device = mesh.device
    with annotate("xpysom.upload", bytes=(hi - lo) * d * 4):
        chunks, mask = _feed(data2d[lo:hi], c, chunk, device)
    return chunks, mask, n


def _search_launches() -> dict:
    """K1's and K2's launches so far (``searches``), and those of them with
    A streamed (``streamed_searches``): what a call span counts of its
    searches."""
    counts = kernels.launch_counts()
    return {"searches": sum(counts[n] for n in kernels.FED),
            "streamed_searches": sum(counts[f"{n}.streamed"] for n in kernels.FED)}


@contextlib.contextmanager
def _call_span(name: str):
    """The call span ``name`` (``annotate``), which also counts the call's
    K1 and K2 launches (:func:`_search_launches`)."""
    with annotate(name) as span:
        before = _search_launches()
        yield span
        span.add(**{k: v - before[k] for k, v in _search_launches().items()})


def _scalar_ratio(total, count) -> float:
    """``total / count`` of two device scalars, read on the host."""
    with annotate("xpysom.fetch"):
        return float(total) / float(count)


def _as_numpy_2d(data) -> np.ndarray:
    if hasattr(data, "compute"):
        data = data.compute()
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(data), dtype=np.float32)


class TuneResult(NamedTuple):
    """``autotune_kernel``'s result, with the JAX package's fields. The
    port's kernels take no tiles: ``tiles`` is None and the timings hold
    the one fixed configuration, under the key None."""

    tiles: Optional[tuple]
    timings_ms: dict
    first_call_s: dict


class XPySom:
    def __init__(
        self,
        x,
        y,
        input_len,
        sigma=0,
        sigmaN=1,
        learning_rate=0.5,
        learning_rateN=0.01,
        decay_function="exponential",
        neighborhood_function="gaussian",
        std_coeff=0.5,
        topology="rectangular",
        activation_distance="euclidean",
        activation_distance_kwargs={},
        random_seed=None,
        n_parallel=0,
        compact_support=False,
        xp=None,
        use_dask=False,
        dask_chunks="auto",
        mesh=None,
        device=None,
        bmu_precision=None,
        use_kernels=None,
    ):
        """Initializes a Self Organizing Map.

        Parameter semantics follow the JAX package's constructor. Port
        specific:

        device : str | torch.device (default: 'cuda'). Where training and
            scoring run. Without a usable card the default raises
            RuntimeError; pass device='cpu' to run on the CPU. With a mesh
            the default is the rank's card (``parallel.mesh``).

        mesh : None | 'auto' | int | torch.distributed.ProcessGroup |
            parallel.DataMesh (default None). Data-parallel training over
            the processes of a process group, one process per card:
            'auto' (or True) is the default group (a world of 1 when none
            is initialized), an int must equal its world size, a group is
            used as given. A (data, model) grid shards the codebook:
            ``parallel.make_grid_mesh(n_data, n_model)``, an
            ``(n_data, n_model)`` pair (the default group, which must hold
            ``n_data * n_model`` processes) or a ``DeviceMesh`` named
            ``('data', 'model')``; X must divide by ``n_model``.
            ``use_dask=True`` maps to mesh='auto' with a warning.

        use_kernels : bool (default True). False runs the plain PyTorch
            versions of the kernels on the card too (the reference's
            ``_no_opt`` testing pattern). On the CPU the plain versions
            always run.

        bmu_precision : validated and resolved like the JAX package
            (default 'highest' for norm_p, else 'packed'); all six modes
            are served ('margin' is refused with norm_p).

        The defaults of ``bmu_precision`` and ``use_kernels`` can be
        overridden by the env switches ``XPYSOM_BMU_PRECISION`` and
        ``XPYSOM_TPU_NO_PALLAS`` (truthy: ``use_kernels=False``), read ONCE
        here at construction as the JAX package reads them; explicit
        arguments always win. ``XPYSOM_BMU_TILES`` is TPU-only and ignored.

        activation_distance : 'euclidean', 'cosine', 'manhattan',
            'norm_p' (``activation_distance_kwargs={'p': ...}``, default
            p=2) or a ``_no_opt`` name. The BMU search routes as the JAX
            package's does: the GEMM-form kernels for euclidean, cosine and
            even p; the elementwise kernels for manhattan, odd p and
            non-integer p; a plain distance matrix for the ``_no_opt``
            names and p <= 0.
        """
        if sigma >= x or sigma >= y:
            warn("Warning: sigma is too high for the dimension of the map.")

        self._random_generator = np.random.RandomState(random_seed)

        if xp is not None:
            warn("xp= is ignored: computation always runs on PyTorch.")
        if use_dask:
            warn("use_dask is deprecated: mapping to mesh='auto' (shard_map DP).")
            if mesh is None:
                mesh = "auto"
        self.dask_chunks = dask_chunks  # accepted, unused

        self._learning_rate = learning_rate
        self._learning_rateN = learning_rateN
        self._sigma = min(x, y) / 2 if sigma == 0 else sigma
        self._sigmaN = sigmaN
        self._std_coeff = std_coeff
        self._input_len = input_len
        self._x = x
        self._y = y

        # uniform in [-1, 1), each code vector L2-normalized (float64 on
        # the host, as the JAX package keeps it)
        self._weights = self._random_generator.rand(x, y, input_len) * 2 - 1
        self._weights /= np.linalg.norm(self._weights, axis=-1, keepdims=True)

        if topology not in ["hexagonal", "rectangular"]:
            msg = "%s not supported only hexagonal and rectangular available"
            raise ValueError(msg % topology)
        self.topology = topology
        # euclidean coordinate meshes, shape (y, x), hex offset applied
        self._xx, self._yy = core.grid_coordinates(x, y, topology)
        if topology == "hexagonal" and neighborhood_function in ["triangle"]:
            # the reference warns, then raises below: hexagonal grids
            # offer no triangle
            warn(
                "triangle neighborhood function does not "
                + "take in account hexagonal topology"
            )
        if decay_function not in DECAY_REGISTRY:
            msg = "%s not supported. Functions available: %s"
            raise ValueError(msg % (decay_function, ", ".join(DECAY_REGISTRY.keys())))
        self._decay_function_name = decay_function
        self.compact_support = compact_support
        available = _RECT_NEIGS if topology == "rectangular" else _HEX_NEIGS
        if neighborhood_function not in available:
            msg = "%s not supported. Functions available: %s"
            raise ValueError(msg % (neighborhood_function, ", ".join(available)))
        self.neighborhood_func_name = neighborhood_function

        self._activation_distance_name = activation_distance
        self._activation_distance_kwargs = dict(activation_distance_kwargs)
        dist_obj = DistanceFunction(activation_distance, self._activation_distance_kwargs)

        # validation, resolution and the env reads live at the one
        # boundary, SomSpec.__post_init__ (the norm_p rules need the
        # distance); an omitted argument is read from the env there, once,
        # and the resolved values are stored, so a later env change never
        # reaches this model
        cfg = SomSpec(
            1, 1, 1, 1.0, 1.0, 0.5, 0.01, distance=activation_distance,
            bmu_precision=core.FROM_ENV if bmu_precision is None else bmu_precision,
            use_kernels=core.FROM_ENV if use_kernels is None else use_kernels,
        )
        self._bmu_precision = cfg.bmu_precision
        self._use_kernels = cfg.use_kernels
        # written into checkpoints only when explicit, as the JAX package
        # writes use_pallas: the loading host's env switch then applies
        self._use_kernels_explicit = use_kernels is not None
        if self._bmu_precision == "split2" and input_len < 32:
            # split2's self-consistent ‖w_h‖² makes nodes whose bf16
            # shadows coincide tie exactly, and the first-index tie-break
            # then starves the later nodes (the JAX package's measured map
            # collapse on low-D clustered data)
            warn(
                f"bmu_precision='split2' with input_len={input_len} < 32: "
                "coincident bf16 codebook shadows can starve nodes during "
                "training (map collapse; BASELINE.md round 5). split2 only "
                "outruns 'packed' at wide D — prefer 'packed' here."
            )

        # the device as the caller gave it (None: the card, the rank's card
        # under a mesh) and as resolved here; a pickle keeps the first and
        # resolves it again on the loading host, at first use
        self._device_arg = device
        self._mesh_arg = mesh
        self._mesh = resolve_mesh(mesh, device)
        self._resolved_device = (
            self._mesh.device if self._mesh is not None else resolve_device(device)
        )
        # The kernels' chunk default (16384) is only safe where the search
        # never builds the (chunk, XY) distance matrix: ask the dispatch
        # gate, as the JAX model does
        self._n_parallel_explicit = n_parallel != 0
        if n_parallel == 0:
            fused = (
                self._device.type == "cuda"
                and core._kernel_bmu_kind(dist_obj, self._use_kernels) is not None
            )
            n_parallel = default_n_parallel(x * y, self._device.type, fused=fused)
        self._n_parallel = int(n_parallel)

    @classmethod
    def from_numpy(cls, weights, **kwargs):
        """A model whose codebook is ``weights`` (an (X, Y, D) array, e.g.
        a JAX model's ``_weights``); ``kwargs`` are constructor
        arguments."""
        weights = np.asarray(weights)
        if weights.ndim != 3:
            raise ValueError(f"(X, Y, D) weights expected, got {weights.shape}")
        som = cls(*weights.shape, **kwargs)
        som._weights = weights.copy()
        return som

    @property
    def _device(self) -> torch.device:
        """Where this model computes: ``device=`` as given to the
        constructor, None meaning the card (``RuntimeError`` without
        one)."""
        if self._resolved_device is None:
            self._resolved_device = resolve_device(self._device_arg)
        return self._resolved_device

    def __getstate__(self):
        """Pickle support: drop the resolved device and the mesh, keep the
        device the caller gave and the mesh argument, a process group as
        its world size and a grid as ``(n_data, n_model)`` (the JAX package
        drops its device handles and keeps a mesh's shape likewise)."""
        state = self.__dict__.copy()
        state["_resolved_device"] = None
        state["_mesh"] = None
        if self._is_grid:
            state["_mesh_arg"] = (self._mesh.n_data, self._mesh.n_model)
        elif self._mesh is not None and not isinstance(self._mesh_arg, (bool, str, int)):
            state["_mesh_arg"] = self._mesh.world
        return state

    def __setstate__(self, state):
        """Resolve the mesh again on the loading host; where it cannot be
        (fewer processes, no card), the model runs without one, as the JAX
        package falls back to a single device."""
        self.__dict__.update(state)
        try:
            self._mesh = resolve_mesh(state.get("_mesh_arg"), self._device_arg)
        except (ValueError, RuntimeError):
            self._mesh = self._mesh_arg = None
        if self._mesh is not None:
            self._resolved_device = self._mesh.device

    @property
    def _is_grid(self) -> bool:
        return isinstance(self._mesh, GridMesh)

    @property
    def _spec(self) -> SomSpec:
        return SomSpec(
            x=self._x,
            y=self._y,
            input_len=self._input_len,
            sigma=float(self._sigma),
            sigmaN=float(self._sigmaN),
            learning_rate=float(self._learning_rate),
            learning_rateN=float(self._learning_rateN),
            decay=self._decay_function_name,
            neighborhood=self.neighborhood_func_name,
            std_coeff=float(self._std_coeff),
            topology=self.topology,
            distance=self._activation_distance_name,
            distance_kwargs=tuple(sorted(self._activation_distance_kwargs.items())),
            compact_support=bool(self.compact_support),
            bmu_precision=self._bmu_precision,
            use_kernels=self._use_kernels,
        )

    @property
    def _matrix_chunk(self) -> int:
        """Chunk size for paths that build the (chunk, XY) distance matrix
        (the plain versions of the searches): the kernels' default would
        allocate chunk·XY·4 bytes, so an auto-sized SOM falls back to the
        element-budgeted default here. An explicit ``n_parallel`` is
        honored everywhere (it is the reference's memory bound)."""
        if self._n_parallel_explicit:
            return self._n_parallel
        return min(self._n_parallel, default_n_parallel(self._x * self._y, self._device.type))

    def _chunked(self, data2d: np.ndarray, chunk: int = None):
        """Chunk host data, padded, on the device (with a mesh,
        this rank's block: ``_chunks_on``). One chunk rule for training and
        inference: eager PyTorch has no compiled shapes to bucket.
        ``chunk`` overrides the budget ``n_parallel``."""
        chunk = training_chunk(data2d.shape[0], chunk or self._n_parallel)
        return _chunks_on(data2d, chunk, self._mesh, self._device)

    def _device_weights(self):
        """The codebook as f32 on the device; over a grid, this rank's
        X-slice. Its upload span counts the bytes and the codebook rows
        sent (``units``), by which a reader tells it from the rows'
        uploads."""
        with annotate("xpysom.upload") as span:
            w = np.asarray(self._weights, dtype=np.float32)
            if self._is_grid:
                n_model = self._mesh.n_model
                if self._x % n_model:
                    raise ValueError(
                        f"grid X={self._x} must divide evenly over {n_model} "
                        f"model shards (codebook shards along X)"
                    )
                w = np.ascontiguousarray(grid_sharded.local_slice(w, self._mesh))
            span.add(bytes=w.nbytes, units=w.shape[0] * w.shape[1])
            return torch.from_numpy(w).to(self._device)

    def _to_host(self, w) -> np.ndarray:
        """The full codebook on the host from the device's (over a grid,
        this rank's X-slice: gathered over the model group)."""
        if self._is_grid:
            w = grid_sharded.gather_codebook(w, self._mesh)
        if w.device.type == "cuda":
            # the fetch's span times the copy, not the kernels queued before it
            torch.cuda.current_stream(w.device).synchronize()
        with annotate("xpysom.fetch", bytes=w.numel() * w.element_size()):
            return w.cpu().numpy()

    def get_weights(self):
        """Returns the weights of the neural network (numpy)."""
        return self._weights

    def _check_input_len(self, data):
        if getattr(data, "ndim", 0) >= 2:
            data_len = data.shape[-1]
        else:
            data_len = len(data[0])
        if self._input_len != data_len:
            msg = "Received %d features, expected %d." % (data_len, self._input_len)
            raise ValueError(msg)

    # -- streaming (out-of-core) helpers ------------------------------------------

    @staticmethod
    def _as_source(data):
        """DataSource for source-like inputs (anything with
        ``superbatches`` or an ``np.memmap``), else None."""
        if hasattr(data, "superbatches"):
            return data
        if isinstance(data, np.memmap):
            return ArraySource(data)
        return None

    def _superbatch_rows(self) -> int:
        """~256 MB device-resident blocks — the pipeline's shared rule."""
        return default_superbatch_rows(self._input_len)

    def _guard_multihost_streaming_inference(self):
        """Streaming INFERENCE over a mesh that spans processes is gated:
        per-rank sources yield per-rank-distinct blocks whose outputs are
        not gathered on the inference paths (only the training loop keeps
        the ranks in step, ``parallel.pipeline._synced_superbatches``), so
        per-row outputs would interleave wrongly. Run inference per
        process with mesh=None (it is embarrassingly parallel), or pass
        resident (process-identical) data."""
        if mesh_spans_processes(self._mesh):
            raise NotImplementedError(
                "streaming inference over a multi-host mesh is not "
                "supported: run it per host with mesh=None (per-row "
                "inference is embarrassingly parallel) or pass resident "
                "data (identical on every process)"
            )

    def _stream(self, src, chunk=None):
        """The superbatches of ``src`` on the device as ``(chunks, mask,
        n)``, through the pipeline's streamed feed (the pinned ring on a
        side stream on the card). ``chunk`` overrides the budget
        ``n_parallel``. Every streamed scoring path comes through here, so
        the multi-process guard is checked here, before the first
        superbatch."""
        self._guard_multihost_streaming_inference()
        rows = self._superbatch_rows()
        chunk = training_chunk(rows, chunk or self._n_parallel)
        for chunks, mask, n in device_superbatches(src, rows, chunk, self._device):
            self._check_input_len(chunks)
            yield chunks, mask, n

    def _stream_winners(self, src):
        """Flat winners of each superbatch of ``src`` on the device, as
        ``(winners, n)``, the codebook uploaded once. A caller keeps at
        most one superbatch's winners on the device."""
        bmu_fn = core.make_bmu_fn(self._spec)
        w = self._device_weights()
        for chunks, _, n in self._stream(src):
            yield bmu_fn(w, chunks).reshape(-1)[:n], n

    def _stream_predict(self, src) -> np.ndarray:
        """Flat winners of every row of ``src`` on the host. On the card
        each superbatch's winners are copied, without waiting, into one of
        two pinned staging buffers behind an event; a buffer is drained
        into the host output when its turn comes again (its copy, two
        superbatches back, has long finished) and at the end. The card
        holds one superbatch's winners and the pinned memory two, whatever
        the row count."""
        out, at = np.empty(len(src), dtype=np.int64), 0
        staged = [None, None]  # per slot: (pinned winners, event of the copy, offset, rows)

        def put(start, values):
            nonlocal out
            end = start + len(values)
            if end > len(out):  # a source longer than its len()
                out = np.concatenate([out, np.empty(end - len(out), dtype=np.int64)])
            out[start:end] = values

        def drain(slot):
            pinned, done, start, n = slot
            done.synchronize()
            put(start, pinned[:n].numpy())

        for k, (win, n) in enumerate(self._stream_winners(src)):
            if win.device.type != "cuda":
                put(at, win.numpy())
            else:
                slot = staged[k % 2]
                if slot is not None:
                    drain(slot)
                pinned = slot[0] if slot is not None and slot[0].shape[0] >= n else (
                    torch.empty(n, dtype=win.dtype, pin_memory=True))
                pinned[:n].copy_(win, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                staged[k % 2] = (pinned, done, at, n)
            at += n
        for slot in staged:
            if slot is not None:
                drain(slot)
        return out[:at]

    # -- winner ---------------------------------------------------------------

    def _winner_flat(self, data2d: np.ndarray, spec: SomSpec = None) -> np.ndarray:
        """Flat winners of ``data2d`` under ``spec`` (default: the model's,
        so by the activation distance)."""
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            return np.empty(0, dtype=np.int64)
        chunks, _, n = self._chunked(data2d)
        if self._is_grid:
            bmu = grid_sharded.make_bmu_fn_2d(spec or self._spec, self._mesh)(
                self._device_weights(), chunks)
            # every data index's winners, in order, on every rank
            bmu = fetch_global(bmu, self._mesh.data)
        else:
            bmu = core.make_bmu_fn(spec or self._spec, self._mesh)(self._device_weights(), chunks)
            # every rank's winners, in rank order, on every rank
            bmu = fetch_global(bmu, self._mesh)
        with annotate("xpysom.fetch"):
            return bmu.reshape(-1)[:n].cpu().numpy()

    def winner(self, x):
        """Coordinates of the winning neurons for samples x."""
        arr = _as_numpy_2d(x)
        single = arr.ndim <= 1
        flat = self._winner_flat(np.atleast_2d(arr))
        wx, wy = flat // self._y, flat % self._y
        if single:
            return (int(wx[0]), int(wy[0]))
        return [(int(a), int(b)) for a, b in zip(wx, wy)]

    def predict(self, data):
        """Flat (raveled) winner index per sample. Source-like data streams
        through the card in superbatches."""
        with annotate("xpysom.predict") as span:
            src = self._as_source(data)
            if src is not None:
                return self._stream_predict(src)
            data2d = np.atleast_2d(_as_numpy_2d(data))
            span.add(rows=data2d.shape[0])
            return self._winner_flat(data2d).astype(np.int64)

    # -- training ---------------------------------------------------------------

    def train(
        self,
        data,
        num_epochs,
        iter_beg=0,
        iter_end=None,
        verbose=False,
        checkpoint_path=None,
        checkpoint_every=0,
    ):
        """Trains the SOM: epochs ``[iter_beg, iter_end)`` of a
        ``num_epochs``-epoch schedule (decays computed against the total,
        so segmented training composes).

        Source-like data (a DataSource or an ``np.memmap``) streams
        through the card in superbatches (``parallel.pipeline``); with
        superbatches of whole chunks the result equals resident training
        bit for bit.

        ``checkpoint_path`` + ``checkpoint_every=k`` write a portable .npz
        checkpoint every k epochs and at the end: after a failure,
        ``XPySom.load_checkpoint(path)`` and ``train(data, num_epochs,
        iter_beg=ckpt._checkpoint_epoch)`` resume bit for bit.
        ``verbose=True`` prints a progress bar and, at the end, the
        quantization error (of the first superbatch for streamed data).

        With a mesh, every rank calls ``train`` with the same resident data
        (each trains on its block of the chunks) or with its own source
        (``ShardedFileSource`` reads ``files[rank::world]``); every rank
        ends with the same codebook, and rank 0 writes the checkpoints.
        Over a grid each rank trains its X-slice on its data index's
        chunks and every rank ends with the full codebook."""
        with _call_span("xpysom.train") as span:
            return self._train(span, data, num_epochs, iter_beg, iter_end, verbose,
                               checkpoint_path, checkpoint_every)

    def _train(self, span, data, num_epochs, iter_beg, iter_end, verbose, checkpoint_path,
               checkpoint_every):
        """``train`` inside its call span ``span``."""
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every={checkpoint_every} must be >= 0")
        if iter_end is None:
            iter_end = num_epochs
        src = self._as_source(data)
        if src is not None:
            n = len(src)
            span.add(rows=n)
            w = np.asarray(self._weights, dtype=np.float32)

            def run(w, beg, end, progress):
                return train_streaming(
                    self._spec, w, src, num_epochs, iter_beg=beg, iter_end=end,
                    chunk=self._n_parallel, superbatch_rows=self._superbatch_rows(),
                    device=self._device, mesh=self._mesh, progress=progress,
                )

            def to_host(w):
                return w
        else:
            data2d = _as_numpy_2d(data)
            self._check_input_len(data2d)
            span.add(rows=data2d.shape[0])
            chunks, mask, n = self._chunked(data2d)
            if self._is_grid:
                train_fn = grid_sharded.make_train_fn_2d(self._spec, num_epochs, self._mesh)
            else:
                train_fn = core.make_train_fn(self._spec, num_epochs, self._mesh)
            w = self._device_weights()

            def run(w, beg, end, progress):
                return train_fn(w, chunks, mask, beg, end, progress)

            to_host = self._to_host

        progress = None
        if verbose:
            reporter = ProgressReporter(num_epochs * n)
            reporter.start()

            def progress(t):
                reporter.update(t * n + n - 1)

        checkpoints = bool(checkpoint_every and checkpoint_path)
        seg = checkpoint_every if checkpoints else iter_end - iter_beg
        for seg_beg in range(iter_beg, iter_end, max(seg, 1)):
            seg_end = min(seg_beg + seg, iter_end)
            w = run(w, seg_beg, seg_end, progress)
            if checkpoints:
                self._weights = to_host(w)
                self.save_checkpoint(checkpoint_path, epoch=seg_end)
        self._weights = to_host(w)

        if verbose:
            if src is None:
                print("\n quantization error:", self.quantization_error(data2d))
            else:
                # full-source QE would stream everything again: the first
                # superbatch is a bounded, deterministic sample; an empty or
                # exhausted one-shot source skips the print
                try:
                    sample = next(iter(src.superbatches(min(n, 65536))))
                except (StopIteration, ValueError):
                    sample = None
                if sample is not None and len(sample):
                    print("\n quantization error:", self.quantization_error(sample))
        return self

    def train_batch(self, data, num_iteration, verbose=False):
        """Compatibility with MiniSom, alias for train."""
        return self.train(data, num_iteration, verbose=verbose)

    def train_random(self, data, num_iteration, verbose=False):
        """Compatibility with MiniSom, alias for train."""
        print(
            "WARNING: due to batch SOM algorithm, random order is not "
            "supported. Falling back to train_batch."
        )
        return self.train(data, num_iteration, verbose=verbose)

    # -- metrics ----------------------------------------------------------------

    @staticmethod
    def _mean_of(parts, what):
        """``Σ totals / Σ counts`` over per-superbatch ``(total, count)``
        device scalars, folded on the host in superbatch order (one
        synchronization at the end); NaN with a warning for no rows."""
        tot = n = 0.0
        for t, c in parts:
            tot += float(t)
            n += float(c)
        if n == 0:
            warn(f"{what}: source yielded no rows.")
            return float("nan")
        return tot / n

    def quantization_error(self, data):
        """Mean distance between samples and their BMU code vectors.
        Source-like data streams in superbatches, folding (Σ errors,
        Σ count) on the host."""
        with _call_span("xpysom.quantization_error") as span:
            src = self._as_source(data)
            if src is not None:
                fn = core.make_quantization_stats_fn(self._spec)
                w = self._device_weights()
                return self._mean_of([fn(w, c, m) for c, m, _ in self._stream(src)],
                                     "quantization_error")
            data2d = np.atleast_2d(_as_numpy_2d(data))
            self._check_input_len(data2d)
            span.add(rows=data2d.shape[0])
            if data2d.shape[0] == 0:
                warn("quantization_error: received no rows.")
                return float("nan")
            chunks, mask, _ = self._chunked(data2d)
            if self._is_grid:
                fn = grid_sharded.make_quantization_stats_fn_2d(self._spec, self._mesh)
            else:
                fn = core.make_quantization_stats_fn(self._spec, self._mesh)
            tot, n = fn(self._device_weights(), chunks, mask)
            return _scalar_ratio(tot, n)

    @property
    def _te_chunk(self):
        """TE's chunk budget: K2 keeps the distance matrix on chip and
        takes training's chunk; its plain version builds the matrix."""
        k2 = self._use_kernels and self._device.type == "cuda"
        return None if k2 else self._matrix_chunk

    def topographic_error(self, data):
        """Fraction of samples whose two best-matching units are not
        adjacent. Source-like data streams in superbatches like
        ``quantization_error``."""
        if self._x * self._y == 1:
            warn("The topographic error is not defined for a 1-by-1 map.")
            return np.nan
        with _call_span("xpysom.topographic_error") as span:
            src = self._as_source(data)
            if src is not None:
                fn = core.make_topographic_stats_fn(self._spec)
                w = self._device_weights()
                return self._mean_of(
                    [fn(w, c, m) for c, m, _ in self._stream(src, self._te_chunk)],
                    "topographic_error")
            data2d = np.atleast_2d(_as_numpy_2d(data))
            self._check_input_len(data2d)
            span.add(rows=data2d.shape[0])
            if data2d.shape[0] == 0:
                warn("topographic_error: received no rows.")
                return float("nan")
            if self._is_grid and self._x * self._y // self._mesh.n_model < 2:
                # fewer than two rows a shard leave the sharded top-2 merge
                # undefined: every rank scores on its device from the host
                # codebook, as the JAX package falls back to one device
                chunk = training_chunk(data2d.shape[0], self._te_chunk or self._n_parallel)
                chunks, mask, _ = _chunks_on(data2d, chunk, None, self._device)
                with annotate("xpysom.upload") as up:
                    w = np.asarray(self._weights, dtype=np.float32)
                    up.add(bytes=w.nbytes, units=self._x * self._y)
                    w = torch.from_numpy(w).to(self._device)
                errs, n = core.make_topographic_stats_fn(self._spec)(w, chunks, mask)
                return _scalar_ratio(errs, n)
            chunks, mask, _ = self._chunked(data2d, self._te_chunk)
            if self._is_grid:
                fn = grid_sharded.make_topographic_stats_fn_2d(self._spec, self._mesh)
            else:
                fn = core.make_topographic_stats_fn(self._spec, self._mesh)
            errs, n = fn(self._device_weights(), chunks, mask)
            return _scalar_ratio(errs, n)

    # -- weight initialization --------------------------------------------------

    def random_weights_init(self, data):
        """Init weights by picking random data samples (same draws as the
        JAX package for the same seed)."""
        self._check_input_len(data)
        data = np.asarray(data)
        idx = self._random_generator.randint(len(data), size=self._x * self._y)
        self._weights[...] = data[idx].reshape(self._x, self._y, self._input_len)

    def pca_weights_init(self, data):
        """Init weights spanning the first two principal components."""
        if self._input_len == 1:
            msg = "The data needs at least 2 features for pca initialization"
            raise ValueError(msg)
        self._check_input_len(data)
        if self._x == 1 or self._y == 1:
            msg = (
                "PCA initialization inappropriate:"
                + "One of the dimensions of the map is 1."
            )
            warn(msg)
        pc_length, pc = np.linalg.eig(np.cov(np.transpose(data)))
        pc_order = np.argsort(-pc_length)
        c1 = np.linspace(-1, 1, self._x)[:, None, None]
        c2 = np.linspace(-1, 1, self._y)[None, :, None]
        self._weights[...] = c1 * pc[pc_order[0]] + c2 * pc[pc_order[1]]

    # -- analysis ---------------------------------------------------------------

    def get_euclidean_coordinates(self):
        """Euclidean-plane positions of the neurons as two meshgrids."""
        return self._xx.T, self._yy.T

    def convert_map_to_euclidean(self, xy):
        """Map coordinates → euclidean coordinates for the topology."""
        return self._xx.T[xy], self._yy.T[xy]

    def _chunked_matrix(self, data2d: np.ndarray, w_flat, fn) -> np.ndarray:
        """The (N, XY) matrix ``fn(x, w_flat)`` on the host, computed on
        the device in chunks of ``_matrix_chunk`` rows (the result may
        dwarf device memory; one chunk's matrix is on the device at a
        time)."""
        n, xy = data2d.shape[0], w_flat.shape[0]
        out = np.empty((n, xy), dtype=np.float32)
        step = max(1, self._matrix_chunk)
        for s in range(0, n, step):
            x = torch.from_numpy(data2d[s : s + step]).to(self._device)
            out[s : s + step] = fn(x, w_flat).cpu().numpy()
        return out

    def activate(self, x):
        """Activation map for x: element (n, j) is the response of flat
        neuron j to sample n under the activation distance. For the
        default 'euclidean' this is the partial squared distance
        (argmin-equivalent). Under 'manhattan' the matrix is K8 on the card
        (its plain version with ``use_kernels=False``)."""
        x2d = np.atleast_2d(_as_numpy_2d(x))
        self._check_input_len(x2d)
        dist = self._spec.distance_fn()
        fn = dist.flat
        if dist.name == "manhattan" and not self._use_kernels:
            fn = manhattan_distance_no_opt  # K8's plain version
        w_flat = self._device_weights().reshape(-1, self._input_len)
        return self._chunked_matrix(x2d, w_flat, fn)

    def distance_from_weights(self, data, weights=None):
        """Full (N, X·Y) euclidean distance matrix against ``weights``
        (default: this SOM's codebook), on the host, computed in budgeted
        chunks."""
        data2d = np.atleast_2d(_as_numpy_2d(data))
        w_host = np.asarray(self._weights if weights is None else weights, dtype=np.float32)
        w_flat = torch.from_numpy(np.ascontiguousarray(w_host.reshape(-1, self._input_len)))
        return self._chunked_matrix(data2d, w_flat.to(self._device), euclidean_distance)

    def quantization(self, data):
        """Code book vector of the winning neuron for each sample: BMU by
        euclidean distance whatever the activation (under the model's
        precision mode), as the reference defines it."""
        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        spec = dataclasses.replace(self._spec, distance="euclidean", distance_kwargs=())
        bmu = self._winner_flat(data2d, spec=spec)
        return self._weights.reshape(-1, self._input_len)[bmu]

    def distance_map(self):
        """U-matrix: normalized sum of distances between each neuron and its
        neighbors (host numpy, one shifted-difference norm per neighbor
        offset)."""
        w = np.asarray(self._weights, dtype=np.float64)
        x_dim, y_dim = w.shape[0], w.shape[1]

        ii = [[0, -1, -1, -1, 0, 1, 1, 1]] * 2
        jj = [[-1, -1, 0, 1, 1, 1, 0, -1]] * 2
        if self.topology == "hexagonal":
            ii = [[1, 1, 1, 0, -1, 0], [0, 1, 0, -1, -1, -1]]
            jj = [[1, 0, -1, -1, 0, 1], [1, 0, -1, -1, 0, 1]]

        def offset_norms(i, j):
            out = np.zeros((x_dim, y_dim))
            x0, x1 = max(0, -i), x_dim - max(0, i)
            y0, y1 = max(0, -j), y_dim - max(0, j)
            if x0 < x1 and y0 < y1:
                out[x0:x1, y0:y1] = np.linalg.norm(
                    w[x0:x1, y0:y1] - w[x0 + i : x1 + i, y0 + j : y1 + j], axis=-1
                )
            return out

        sums = [
            np.sum([offset_norms(i, j) for i, j in zip(ii[e], jj[e])], axis=0)
            for e in (0, 1)
        ]
        if self.topology == "hexagonal":
            # e = (y % 2 == 0) selects the offset set per column parity
            even_col = (np.arange(y_dim) % 2 == 0)[None, :]
            um = np.where(even_col, sums[1], sums[0])
        else:
            um = sums[0]
        return um / um.max()

    def activation_response(self, data):
        """Counts how many times each neuron wins. Source-like data streams
        in superbatches."""
        a = np.zeros((self._x, self._y))
        src = self._as_source(data)
        if src is not None:
            # counts folded per superbatch on the device: integers, so
            # equal to counting every winner at once
            counts = torch.zeros(self._x * self._y, dtype=torch.int64, device=self._device)
            for win, _ in self._stream_winners(src):
                # index_add_, not bincount: bincount reads the winners'
                # range on the host, a wait on the stream per superbatch
                counts.index_add_(0, win.long(), torch.ones_like(win, dtype=torch.int64))
            return a + counts.cpu().numpy().reshape(self._x, self._y)
        flat = self._winner_flat(np.atleast_2d(_as_numpy_2d(data)))
        np.add.at(a, (flat // self._y, flat % self._y), 1)
        return a

    def win_map(self, data):
        """Dict (i, j) → list of samples mapped there."""
        self._check_input_len(data)
        winmap = defaultdict(list)
        for x, win in zip(data, self.winner(data)):
            winmap[win].append(x)
        return winmap

    def labels_map(self, data, labels):
        """Dict (i, j) → Counter of the labels mapped there."""
        self._check_input_len(data)
        if not len(data) == len(labels):
            raise ValueError("data and labels must have the same length.")
        winmap = defaultdict(list)
        for win, label in zip(self.winner(data), labels):
            winmap[win].append(label)
        for position in winmap:
            winmap[position] = Counter(winmap[position])
        return winmap

    # -- introspection, tuning, serialization ---------------------------------

    def get_neig_functions(self):
        """Dictionary of (name, prepared neighborhood callable ``f(c, σ)``)
        for this map's topology, ``c`` the (cx, cy) integer coordinate
        arrays of N centers; each returns an (N, X, Y) float32 tensor on
        the model's device. Hexagonal maps omit 'triangle', as the
        reference does."""
        from ..ops import neighborhoods as nb

        neigx = torch.arange(self._x, dtype=torch.float32, device=self._device)
        neigy = torch.arange(self._y, dtype=torch.float32, device=self._device)
        std, cs = self._std_coeff, self.compact_support
        if self.topology == "rectangular":
            return {
                "gaussian": nb.prepare_neig_func(nb.gaussian_rect, neigx, neigy, std, cs),
                "mexican_hat": nb.prepare_neig_func(nb.mexican_hat_rect, neigx, neigy, std, cs),
                "bubble": nb.prepare_neig_func(nb.bubble, neigx, neigy),
                "triangle": nb.prepare_neig_func(nb.triangle, neigx, neigy, cs),
            }
        xx = torch.as_tensor(self._xx, dtype=torch.float32, device=self._device)
        yy = torch.as_tensor(self._yy, dtype=torch.float32, device=self._device)
        return {
            "gaussian": nb.prepare_neig_func(nb.gaussian_generic, xx, yy, std, cs),
            "mexican_hat": nb.prepare_neig_func(nb.mexican_hat_generic, xx, yy, std, cs),
            "bubble": nb.prepare_neig_func(nb.bubble, neigx, neigy),
        }

    def autotune_kernel(self, apply=True, n_samples=None, reps=10, **kwargs):
        """Time the BMU search that training routes to
        (``core._kernel_bmu_kind``) on the card, at the chunk training uses
        (``utils.hw.training_chunk``; pass ``n_samples=len(data)`` when the
        dataset is smaller than ``n_parallel``), on uniform samples from a
        fixed seed against this model's codebook. The port's kernels take
        no tiles, so there is nothing to choose and ``apply`` sets nothing;
        the JAX package's tile-search options (``candidates=``, ``inner=``,
        ``mode=``) are accepted and ignored. Returns a :class:`TuneResult`
        with ``tiles=None`` and the fixed configuration's mean time over
        ``reps`` calls (CUDA events) and first-call time (host clock,
        synchronized), or None with a warning where this SOM runs no
        kernel (on the CPU, with ``use_kernels=False``, or under an
        activation without one). Over a grid it times the search over this
        rank's shard, the nodes a shard holds."""
        spec = self._spec
        dist = spec.distance_fn()
        if self._device.type != "cuda" or core._kernel_bmu_kind(dist, self._use_kernels) is None:
            warn(
                "autotune_kernel: this SOM runs no BMU kernel here (CPU device, "
                "use_kernels=False, or an activation without a kernel) — nothing "
                "to tune; returning None"
            )
            return None
        x, w_flat = self._tune_operands(n_samples)
        torch.cuda.synchronize(self._device)
        t0 = time.perf_counter()
        search = core._searcher(spec, dist, w_flat)
        search.argmin(x, True)
        torch.cuda.synchronize(self._device)
        first = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            search.argmin(x, True)
        end.record()
        torch.cuda.synchronize(self._device)
        return TuneResult(tiles=None, timings_ms={None: start.elapsed_time(end) / reps},
                          first_call_s={None: first})

    def _tune_operands(self, n_samples=None):
        """``autotune_kernel``'s operands on the device: uniform samples of
        training's chunk (``utils.hw.training_chunk``) from a fixed seed,
        and the codebook rows training searches (over a grid, this rank's
        shard)."""
        chunk = training_chunk(
            int(n_samples) if n_samples is not None else self._n_parallel, self._n_parallel
        )
        gen = torch.Generator(device=self._device).manual_seed(0)
        x = torch.rand((chunk, self._input_len), generator=gen, device=self._device)
        return x, self._device_weights().reshape(-1, self._input_len)

    def save_checkpoint(self, path, *, epoch=None):
        """Portable .npz checkpoint (codebook + RNG + config header) in the
        JAX package's format; see ``utils.serialization``. Pair with
        ``train(..., iter_beg=epoch)`` to resume. With a mesh every rank
        calls it: rank 0 writes, and no rank returns before the file is
        in place."""
        serialization.save_checkpoint(self, path, epoch=epoch)

    @classmethod
    def load_checkpoint(cls, path, *, device=None, mesh=None):
        """A model from a checkpoint of either package, on ``device``
        (default: the card), over ``mesh`` (as the constructor's)."""
        return serialization.load_checkpoint(path, device=device, mesh=mesh)

    def __repr__(self):
        device = self._resolved_device or self._device_arg or "cuda"
        mesh = "" if self._mesh is None else f", mesh={self._mesh!r}"
        return (
            f"XPySom({self._x}x{self._y}, input_len={self._input_len}, "
            f"topology={self.topology!r}, "
            f"neighborhood={self.neighborhood_func_name!r}, "
            f"distance={self._activation_distance_name!r}, "
            f"bmu_precision={self._bmu_precision!r}, "
            f"device={str(device)!r}{mesh})"
        )
