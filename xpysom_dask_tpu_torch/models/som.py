"""MiniSom/XPySom-compatible batch SOM model on the PyTorch core.

Counterpart of ``xpysom_dask_tpu/models/som.py``: the same constructor
surface and the same training and scoring methods, on PyTorch tensors.
``mesh=``, ``bmu_tiles=`` and ``use_pallas=`` give way to ``device=`` and
``use_kernels=``; ``xp=`` and ``dask_chunks=`` are accepted and ignored.
The codebook lives on the host as a numpy array (``get_weights()``),
initialized from numpy's ``RandomState(random_seed)`` exactly as the JAX
package does, so the same seed gives the same initial codebook.

This slice serves the euclidean activation on rectangular grids. The
methods and options still to be ported raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch

from .. import core
from ..core import SomSpec, chunk_data
from ..ops.decays import DECAY_REGISTRY
from ..ops.distances import DistanceFunction
from ..utils.hw import default_n_parallel, training_chunk

__all__ = ["XPySom"]

_RECT_NEIGS = ("gaussian", "mexican_hat", "bubble", "triangle")
_HEX_NEIGS = ("gaussian", "mexican_hat", "bubble")


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 "
        f"item {item})"
    )


def _as_numpy_2d(data) -> np.ndarray:
    if hasattr(data, "compute"):
        data = data.compute()
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(data), dtype=np.float32)


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
        device=None,
        bmu_precision=None,
        use_kernels=None,
    ):
        """Initializes a Self Organizing Map.

        Parameter semantics follow the JAX package's constructor. Port
        specific:

        device : str | torch.device (default: 'cuda' when a card is
            present, else 'cpu'). Where training and scoring run.

        use_kernels : bool (default True). False runs the plain PyTorch
            versions of the kernels on the card too (the reference's
            ``_no_opt`` testing pattern). On the CPU the plain versions
            always run.

        bmu_precision : validated like the JAX package; only 'packed' is
            served.
        """
        if sigma >= x or sigma >= y:
            warn("Warning: sigma is too high for the dimension of the map.")

        self._random_generator = np.random.RandomState(random_seed)

        if xp is not None:
            warn("xp= is ignored: computation always runs on PyTorch.")
        if use_dask:
            _not_ported("use_dask=True (data-parallel training)", 8)
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
        if topology == "hexagonal":
            _not_ported("topology='hexagonal'", 6)

        self._activation_distance_name = activation_distance
        self._activation_distance_kwargs = dict(activation_distance_kwargs)
        DistanceFunction(activation_distance, self._activation_distance_kwargs)

        # validation lives at the one boundary, SomSpec.__post_init__
        cfg = SomSpec(1, 1, 1, 1.0, 1.0, 0.5, 0.01, bmu_precision=bmu_precision,
                      use_kernels=use_kernels)
        self._bmu_precision = cfg.bmu_precision
        self._use_kernels = cfg.use_kernels

        self._device = torch.device(device) if device is not None else _default_device()
        if n_parallel == 0:
            fused = self._use_kernels and self._device.type == "cuda"
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

    def _chunked(self, data2d: np.ndarray):
        """Pad + chunk host data and place it on the device. One chunk
        rule for training and inference: eager PyTorch has no compiled
        shapes to bucket."""
        chunk = training_chunk(data2d.shape[0], self._n_parallel)
        chunks, mask, n = chunk_data(data2d, chunk)
        return (
            torch.from_numpy(chunks).to(self._device),
            torch.from_numpy(mask).to(self._device),
            n,
        )

    def _device_weights(self):
        return torch.from_numpy(np.asarray(self._weights, dtype=np.float32)).to(
            self._device
        )

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

    @staticmethod
    def _reject_source(data):
        if hasattr(data, "superbatches") or isinstance(data, np.memmap):
            _not_ported("streaming (out-of-core) sources", 9)

    # -- winner ---------------------------------------------------------------

    def _winner_flat(self, data2d: np.ndarray) -> np.ndarray:
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            return np.empty(0, dtype=np.int64)
        chunks, _, n = self._chunked(data2d)
        bmu = core.make_bmu_fn(self._spec)(self._device_weights(), chunks)
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
        """Flat (raveled) winner index per sample."""
        self._reject_source(data)
        return self._winner_flat(np.atleast_2d(_as_numpy_2d(data))).astype(np.int64)

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
        so segmented training composes)."""
        self._reject_source(data)
        if verbose:
            _not_ported("verbose progress", 7)
        if checkpoint_path is not None or checkpoint_every:
            _not_ported("checkpoints", 7)
        if iter_end is None:
            iter_end = num_epochs
        data2d = _as_numpy_2d(data)
        self._check_input_len(data2d)
        chunks, mask, _ = self._chunked(data2d)
        train_fn = core.make_train_fn(self._spec, num_epochs)
        w = train_fn(self._device_weights(), chunks, mask, iter_beg, iter_end)
        self._weights = w.cpu().numpy()
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

    def quantization_error(self, data):
        """Mean distance between samples and their BMU code vectors."""
        self._reject_source(data)
        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            warn("quantization_error: received no rows.")
            return float("nan")
        chunks, mask, _ = self._chunked(data2d)
        tot, n = core.make_quantization_stats_fn(self._spec)(
            self._device_weights(), chunks, mask
        )
        return float(tot) / float(n)

    def topographic_error(self, data):
        """Fraction of samples whose two best-matching units are not
        adjacent."""
        if self._x * self._y == 1:
            warn("The topographic error is not defined for a 1-by-1 map.")
            return np.nan
        self._reject_source(data)
        data2d = np.atleast_2d(_as_numpy_2d(data))
        self._check_input_len(data2d)
        if data2d.shape[0] == 0:
            warn("topographic_error: received no rows.")
            return float("nan")
        chunks, mask, _ = self._chunked(data2d)
        errs, n = core.make_topographic_stats_fn(self._spec)(
            self._device_weights(), chunks, mask
        )
        return float(errs) / float(n)

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

    # -- not ported yet -----------------------------------------------------------

    def activate(self, x):
        _not_ported("activate", 7)

    def distance_from_weights(self, data, weights=None):
        _not_ported("distance_from_weights", 7)

    def quantization(self, data):
        _not_ported("quantization", 7)

    def distance_map(self):
        _not_ported("distance_map", 7)

    def activation_response(self, data):
        _not_ported("activation_response", 7)

    def win_map(self, data):
        _not_ported("win_map", 7)

    def labels_map(self, data, labels):
        _not_ported("labels_map", 7)

    def get_neig_functions(self):
        _not_ported("get_neig_functions", 7)

    def get_euclidean_coordinates(self):
        _not_ported("get_euclidean_coordinates", 7)

    def convert_map_to_euclidean(self, xy):
        _not_ported("convert_map_to_euclidean", 7)

    def autotune_kernel(self, apply=True, n_samples=None, **kwargs):
        _not_ported("autotune_kernel", 7)

    def save_checkpoint(self, path, *, epoch=None):
        _not_ported("save_checkpoint", 7)

    @classmethod
    def load_checkpoint(cls, path, **kwargs):
        _not_ported("load_checkpoint", 7)

    def __repr__(self):
        return (
            f"XPySom({self._x}x{self._y}, input_len={self._input_len}, "
            f"topology={self.topology!r}, "
            f"neighborhood={self.neighborhood_func_name!r}, "
            f"distance={self._activation_distance_name!r}, "
            f"device={str(self._device)!r})"
        )
