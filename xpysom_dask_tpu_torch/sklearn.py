"""scikit-learn adapter: SOM as a clusterer/transformer (counterpart of
``xpysom_dask_tpu/sklearn.py``).

``SomClusterer`` packages the boilerplate of gluing a SOM into sklearn
pipelines (fit -> train, predict -> flat BMU index, transform -> node
distances):

    from xpysom_dask_tpu_torch.sklearn import SomClusterer
    pipe = make_pipeline(StandardScaler(), SomClusterer(8, 8, num_epochs=20))
    labels = pipe.fit_predict(X)          # flat BMU index per sample
    dists  = pipe.transform(X)            # (N, x*y) distances to every node

sklearn is an optional dependency: importing this module requires it, the
rest of the package does not. Estimator semantics follow the sklearn
protocol (params stored verbatim in __init__ for clone()/get_params(),
state learned in fit() lives in trailing-underscore attributes).
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.base import BaseEstimator, ClusterMixin, TransformerMixin
    from sklearn.utils.validation import check_is_fitted
except ImportError as e:  # pragma: no cover
    raise ImportError(
        "xpysom_dask_tpu_torch.sklearn requires scikit-learn; "
        "pip install scikit-learn"
    ) from e

try:  # sklearn >= 1.6
    from sklearn.utils.validation import validate_data as _validate_data
except ImportError:  # pragma: no cover - older sklearn: method form

    def _validate_data(estimator, X, **kwargs):
        return estimator._validate_data(X, **kwargs)

from .models.som import XPySom

__all__ = ["SomClusterer"]


class SomClusterer(ClusterMixin, TransformerMixin, BaseEstimator):
    """Self-Organizing Map with the sklearn clusterer/transformer API.

    Parameters mirror :class:`xpysom_dask_tpu_torch.XPySom` minus
    ``input_len``, which is inferred from the data at fit time, plus:

    num_epochs : int — training epochs for ``fit``.
    init : 'random' | 'pca' | 'samples' — codebook initialization
        (seeded uniform / PCA-plane span / random data samples).
    device : str | torch.device (default: the card) — forwarded to
        ``XPySom``: without a usable card the default raises
        RuntimeError; pass device='cpu' to run on the CPU.

    Attributes after ``fit``: ``som_`` (the fitted XPySom), ``labels_``
    (flat BMU index of the training data), ``cluster_centers_``
    ((x*y, D) codebook, sklearn naming), ``quantization_error_``.
    """

    def __init__(
        self,
        x=8,
        y=8,
        num_epochs=10,
        sigma=0,
        sigmaN=1,
        learning_rate=0.5,
        learning_rateN=0.01,
        decay_function="exponential",
        neighborhood_function="gaussian",
        std_coeff=0.5,
        topology="rectangular",
        activation_distance="euclidean",
        activation_distance_kwargs=None,
        random_seed=None,
        n_parallel=0,
        compact_support=False,
        mesh=None,
        init="random",
        device=None,
    ):
        self.x = x
        self.y = y
        self.num_epochs = num_epochs
        self.sigma = sigma
        self.sigmaN = sigmaN
        self.learning_rate = learning_rate
        self.learning_rateN = learning_rateN
        self.decay_function = decay_function
        self.neighborhood_function = neighborhood_function
        self.std_coeff = std_coeff
        self.topology = topology
        self.activation_distance = activation_distance
        self.activation_distance_kwargs = activation_distance_kwargs
        self.random_seed = random_seed
        self.n_parallel = n_parallel
        self.compact_support = compact_support
        self.mesh = mesh
        self.init = init
        self.device = device

    def _make_som(self, input_len):
        return XPySom(
            self.x,
            self.y,
            input_len,
            sigma=self.sigma,
            sigmaN=self.sigmaN,
            learning_rate=self.learning_rate,
            learning_rateN=self.learning_rateN,
            decay_function=self.decay_function,
            neighborhood_function=self.neighborhood_function,
            std_coeff=self.std_coeff,
            topology=self.topology,
            activation_distance=self.activation_distance,
            activation_distance_kwargs=self.activation_distance_kwargs or {},
            random_seed=self.random_seed,
            n_parallel=self.n_parallel,
            compact_support=self.compact_support,
            mesh=self.mesh,
            device=self.device,
        )

    def fit(self, X, y=None):
        X = _validate_data(self, X, dtype=np.float32, ensure_min_samples=1)
        if self.init not in ("random", "pca", "samples"):
            raise ValueError(
                f"init={self.init!r} not supported "
                "(expected 'random', 'pca' or 'samples')"
            )
        som = self._make_som(X.shape[1])
        if self.init == "pca":
            som.pca_weights_init(X)
        elif self.init == "samples":
            som.random_weights_init(X)
        som.train(X, self.num_epochs)
        self.som_ = som
        self.labels_ = som.predict(X)
        self.cluster_centers_ = np.asarray(som.get_weights()).reshape(
            -1, X.shape[1]
        )
        self.quantization_error_ = float(som.quantization_error(X))
        return self

    def predict(self, X):
        """Flat BMU index (row-major over the (x, y) grid) per sample."""
        check_is_fitted(self)
        X = _validate_data(self, X, dtype=np.float32, reset=False)
        return self.som_.predict(X)

    def transform(self, X):
        """(N, x*y) euclidean distances from each sample to every node."""
        check_is_fitted(self)
        X = _validate_data(self, X, dtype=np.float32, reset=False)
        return np.asarray(self.som_.distance_from_weights(X))

    def inverse_transform(self, labels):
        """Codebook vector of each flat BMU index (vector quantization).
        Labels must be valid grid indices in ``[0, x*y)`` — in particular
        sklearn's conventional noise label ``-1`` raises instead of
        silently wrapping to the last grid node."""
        check_is_fitted(self)
        labels = np.asarray(labels, dtype=np.int64)
        n_nodes = self.cluster_centers_.shape[0]
        if labels.size and (labels.min() < 0 or labels.max() >= n_nodes):
            raise ValueError(
                f"labels must be flat grid indices in [0, {n_nodes}); got "
                f"range [{labels.min()}, {labels.max()}]"
            )
        return self.cluster_centers_[labels]

    def score(self, X, y=None):
        """Negative quantization error (higher is better, sklearn
        model-selection convention)."""
        check_is_fitted(self)
        X = _validate_data(self, X, dtype=np.float32, reset=False)
        return -float(self.som_.quantization_error(X))
