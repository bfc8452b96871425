"""Codebook (grid) sharding of the PyTorch port across processes, on the CPU.

Four ``torch.distributed`` processes on gloo (a ``file://`` store under the
test's temporary directory) run this file as a script, once for the
module: ``python tests/test_torch_grid_sharded.py --worker RANK 4 DIR``.
The worker imports torch and the port only, never JAX; it drives the port
over ``(2, 2)`` and ``(1, 4)`` grids (a ``(1, 2)`` grid on ranks 0 and 1
too) on inputs made with numpy from fixed seeds and writes its results to
``DIR/rank{RANK}.npz``. The tests hold them against the JAX package's
grids on the same inputs (``conftest.py`` gives JAX 8 virtual CPU
devices, so JAX ``make_grid_mesh(2, 2)``, ``(1, 4)`` and ``(2, 4)`` run in
this process), against the port without a mesh, and rank against rank.
They are the twins of ``tests/test_grid_sharded.py``,
``tests/test_review_fixes.py``'s tiny-map TE fallback,
``tests/test_autotune.py``'s nodes per shard,
``tests/test_scatter_stats.py``'s grid statistics and
``tests/multihost_worker.py``'s grid streaming and model-spans-processes
checkpoint.

Tolerances, as the JAX tests hold JAX's grids: training at rtol 1e-4, atol
1e-5 against JAX's grid and the port's single process; ``predict``,
``winner`` and ``quantization`` equal; QE at rtol 1e-6; TE exact on
identical weights; the statistics' ``cnt`` exact and ``S`` at rtol 1e-6,
atol 1e-6 (``tests/multihost_worker.py``). Bitwise: every rank's codebook
against the others', the checkpoint file and the resumed run, a ``(1, 1)``
grid against no mesh, a ``DeviceMesh`` grid against the pair, and a
shard's laid-out codebook operand against the full search's columns. On
the CPU the plain K1 is a BLAS ``matmul`` over ``XY / n_model`` columns,
which may block its sums otherwise than the full product, so a
``(1, k)`` grid is held to the training tolerance here, not bit for bit
(the card's K1 computes each column alike, and ``chip_smoke.py`` holds it
bit for bit there).
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CPU = dict(device="cpu")
GRIDS = {"2x2": (2, 2), "1x4": (1, 4)}
# twins of tests/test_grid_sharded.py's fixtures (shape, kwargs, rows, seed, epochs)
TRAIN = dict(shape=(8, 6, 5), kw=dict(random_seed=1, n_parallel=64), n=600, seed=0, epochs=4)
INFER = dict(shape=(4, 7, 4), kw=dict(random_seed=2, n_parallel=32), n=300, seed=1)
MODEL_ONLY = dict(shape=(8, 5, 3), kw=dict(random_seed=3, n_parallel=32), n=256, seed=2, epochs=3)
VERBOSE = dict(shape=(4, 4, 3), kw=dict(random_seed=4, n_parallel=32), n=128, seed=3, epochs=2)
TE = dict(n=400, seed=9, epochs=3)
STREAM = dict(shape=(4, 4, 4), kw=dict(random_seed=3, n_parallel=64), n=512, seed=7, epochs=3)
STATS = dict(shape=(8, 4, 16), kw=dict(random_seed=3, n_parallel=64), n=300, seed=5, epochs=3)
CKPT = dict(shape=(8, 5, 4), kw=dict(sigma=2.0, random_seed=11, n_parallel=32), n=300, seed=4)
ACTIVATIONS = {
    "cosine": dict(activation_distance="cosine"),
    "manhattan": dict(activation_distance="manhattan"),
    "norm_p4": dict(activation_distance="norm_p", activation_distance_kwargs={"p": 4}),
    "norm_p3": dict(activation_distance="norm_p", activation_distance_kwargs={"p": 3}),
    "margin": dict(bmu_precision="margin"),
    "split3": dict(bmu_precision="split3"),
}
# tests/multihost_worker.py's streamed grids: uneven rows a rank
SPEC = dict(x=8, y=5, input_len=4, sigma=3.0, sigmaN=1.0, learning_rate=0.5,
            learning_rateN=0.01)
SPLITS = (100, 80, 70, 50)
MH_STREAM = dict(chunk=16, superbatch_rows=64, epochs=3)


def _data(n, d, seed):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def _data_of(cfg):
    return _data(cfg["n"], cfg["shape"][2], cfg["seed"])


def _mh_inputs():
    rng = np.random.RandomState(8)
    full = rng.rand(sum(SPLITS), SPEC["input_len"]).astype(np.float32)
    w0 = rng.rand(SPEC["x"], SPEC["y"], SPEC["input_len"]).astype(np.float32)
    return full, w0


# -- the worker ---------------------------------------------------------------------


def _worker(rank, world, root):
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from xpysom_dask_tpu_torch import SomPopulation, XPySom
    from xpysom_dask_tpu_torch.core import SomSpec, chunk_data, make_stats_fn
    from xpysom_dask_tpu_torch.parallel import (
        ArraySource,
        initialize_multihost,
        make_grid_mesh,
        put_with_sharding,
        resolve_mesh,
        train_streaming,
    )
    from xpysom_dask_tpu_torch.parallel import grid_sharded as gs

    initialize_multihost(f"file://{root}/rendezvous", world, rank, **CPU)
    out = {"backend": np.asarray(dist.get_backend())}
    meshes = {k: make_grid_mesh(*v, device="cpu") for k, v in GRIDS.items()}
    for k, m in meshes.items():
        out[f"layout_{k}"] = np.asarray([m.rank, m.world, m.data.rank, m.data.world,
                                         m.model.rank, m.model.world])
    for bad in ((3, 3), (1, 2)):
        try:
            make_grid_mesh(*bad, device="cpu")
        except ValueError as exc:
            out[f"size_error_{bad[0]}x{bad[1]}"] = np.asarray(str(exc))

    def som(cfg, grid=None, **kw):
        return XPySom(*cfg["shape"], **cfg["kw"], **CPU,
                      mesh=None if grid is None else GRIDS[grid], **kw)

    # training (test_grid_sharded_train_matches_single, _model_only_mesh)
    for grid in GRIDS:
        out[f"train_{grid}"] = som(TRAIN, grid).train(_data_of(TRAIN), TRAIN["epochs"]).get_weights()
        out[f"model_only_{grid}"] = som(MODEL_ONLY, grid).train(
            _data_of(MODEL_ONLY), MODEL_ONLY["epochs"]).get_weights()
    # the same grid from a DeviceMesh named ('data', 'model')
    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["device_mesh"] = XPySom(*TRAIN["shape"], **TRAIN["kw"], **CPU, mesh=dm).train(
        _data_of(TRAIN), TRAIN["epochs"]).get_weights()
    # every activation and mode, over the model-only grid
    for name, kw in ACTIVATIONS.items():
        out[f"act_{name}"] = som(TRAIN, "1x4", **kw).train(_data_of(TRAIN), 2).get_weights()
    # the verbose path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["verbose"] = som(VERBOSE, "2x2").train(_data_of(VERBOSE), VERBOSE["epochs"],
                                                  verbose=True).get_weights()

    # inference (test_grid_sharded_inference_matches_single)
    x = _data_of(INFER)
    for grid in GRIDS:
        model = som(INFER, grid)
        out[f"predict_{grid}"] = model.predict(x)
        out[f"winner_{grid}"] = np.asarray(model.winner(x[:3]))
        out[f"quantization_{grid}"] = model.quantization(x[:10])
        out[f"qe_{grid}"] = np.asarray(model.quantization_error(x))
        out[f"te_{grid}"] = np.asarray(model.topographic_error(x))
        out[f"response_{grid}"] = model.activation_response(x)
    # the shard's laid-out codebook operand is the full search's columns
    model = som(INFER, "1x4")
    shard = gs._Shard(model._spec, model._spec.distance_fn(), model._mesh,
                      model._device_weights())
    out["shard_center"] = shard.search.center.numpy()
    out["shard_w_aug"] = shard.search.w_aug[:, : shard.rows].contiguous().view(torch.int16).numpy()

    # first-index ties across shards (test_grid_sharded_tie_breaking_first_index)
    tied = XPySom(4, 2, 1, random_seed=0, std_coeff=1, mesh=(1, 4), **CPU)
    tied._weights = np.zeros((4, 2, 1))
    out["tie_all"] = np.asarray(tied.winner(np.array([0.5])))
    tied._weights[2, 1] = 0.5
    out["tie_deep"] = np.asarray(tied.winner(np.array([0.5])))

    # TE exact (test_grid_sharded_topographic_error_exact)
    x = _data(TE["n"], 3, TE["seed"])
    for topology in ("rectangular", "hexagonal"):
        kw = dict(random_seed=4, n_parallel=64, topology=topology, **CPU)
        single = XPySom(8, 8, 3, **kw)
        for grid in GRIDS:
            out[f"te0_{topology}_{grid}"] = np.asarray(
                XPySom(8, 8, 3, **kw, mesh=GRIDS[grid]).topographic_error(x))
        single.train(x, TE["epochs"])
        out[f"te_weights_{topology}"] = single.get_weights()
        for grid in GRIDS:
            sharded = XPySom(8, 8, 3, **kw, mesh=GRIDS[grid])
            sharded._weights = single.get_weights().copy()
            out[f"te1_{topology}_{grid}"] = np.asarray(sharded.topographic_error(x))
    for grid in GRIDS:
        zeros = XPySom(8, 8, 3, random_seed=5, mesh=GRIDS[grid], **CPU)
        zeros._weights = np.zeros((8, 8, 3))
        out[f"te_tied_{grid}"] = np.asarray(zeros.topographic_error(x))
    try:
        XPySom(8, 4, 3, topology="hexagonal", mesh=(2, 2), **CPU).topographic_error(x)
    except ValueError as exc:
        out["hex_error"] = np.asarray(str(exc))
    try:
        gs.make_topographic_stats_fn_2d(SomSpec(4, 1, 3, 1.0, 1.0, 0.5, 0.01), meshes["1x4"])
    except ValueError as exc:
        out["rows_error"] = np.asarray(str(exc))
    # the tiny-map fallback (test_grid_mesh_tiny_map_topographic_error_falls_back)
    out["te_tiny"] = np.asarray(XPySom(2, 1, 5, sigma=1.0, random_seed=3, mesh=(2, 2), **CPU)
                                .topographic_error(_data(200, 5, 2)))

    # validation (test_grid_mesh_validation)
    try:
        XPySom(5, 4, 2, random_seed=0, mesh=(1, 4), **CPU).train(_data(32, 2, 0), 1)
    except ValueError as exc:
        out["x_error"] = np.asarray(str(exc))
    try:
        SomPopulation(2, 4, 4, 3, mesh=(2, 2), **CPU)
    except ValueError as exc:
        out["pop_error"] = np.asarray(str(exc))

    # streaming (test_grid_sharded_streaming_matches_single): rank r streams
    # the r-th quarter of the rows
    x = _data_of(STREAM)
    q = len(x) // world
    model = som(STREAM, "2x2")
    model._superbatch_rows = lambda: 64
    out["stream"] = model.train(ArraySource(x[rank * q:(rank + 1) * q]),
                                STREAM["epochs"]).get_weights()
    # tests/multihost_worker.py: uneven rows a rank, both grids
    full, w0 = _mh_inputs()
    ends = np.cumsum((0,) + SPLITS)
    for grid, m in meshes.items():
        out[f"mh_stream_{grid}"] = train_streaming(
            SomSpec(**SPEC), w0, ArraySource(full[ends[rank]:ends[rank + 1]]),
            MH_STREAM["epochs"], chunk=MH_STREAM["chunk"],
            superbatch_rows=MH_STREAM["superbatch_rows"], mesh=m)

    # the grid's statistics against one process's (test_scatter_stats.py's
    # grid parity)
    x = _data_of(STATS)
    spec = som(STATS)._spec
    w = som(STATS).get_weights().astype(np.float32)
    chunks, mask, _ = chunk_data(x, 32, multiple_of=2)
    m = meshes["2x2"]
    acc = gs.make_stats_fn_2d(spec, m)(torch.from_numpy(np.ascontiguousarray(gs.local_slice(w, m))),
                                       put_with_sharding(chunks, m.data),
                                       put_with_sharding(mask, m.data))
    out["stats_grid"] = gs.fetch_global(acc, m.model).numpy()
    out["stats_one"] = make_stats_fn(spec)(torch.from_numpy(w), torch.from_numpy(chunks),
                                           torch.from_numpy(mask)).numpy()
    out["stats_train"] = som(STATS, "2x2").train(x, STATS["epochs"]).get_weights()

    # nodes per shard (test_som_autotune_kernel_matches_training_shape)
    xt, wt = XPySom(8, 4, 3, n_parallel=512, random_seed=1, mesh=(2, 2), **CPU)._tune_operands()
    out["tune_shape"] = np.asarray([xt.shape[0], wt.shape[0]])

    # checkpoints (multihost_worker.py's model spanning processes) and resume
    ck, x = os.path.join(root, "ck.npz"), _data_of(CKPT)
    span = som(CKPT, "1x4").train(x, 2, checkpoint_path=ck, checkpoint_every=1)
    out["ckpt_span"] = span.get_weights()
    out["ckpt_full"] = som(CKPT, "2x2").train(x, 4).get_weights()
    part = som(CKPT, "2x2").train(x, 4, iter_end=2, checkpoint_path=ck, checkpoint_every=1)
    out["ckpt_part"] = part.get_weights()
    with np.load(ck) as z:
        out["ckpt_file"] = z["weights"]
    loaded = XPySom.load_checkpoint(ck, mesh=(2, 2), **CPU)
    out["ckpt_epoch"] = np.asarray(loaded._checkpoint_epoch)
    out["ckpt_resumed"] = loaded.train(x, 4, iter_beg=2).get_weights()

    # a pickle keeps the grid as (n_data, n_model)
    out["pickle"] = np.frombuffer(pickle.dumps(part), dtype=np.uint8)
    again = pickle.loads(pickle.dumps(part))
    out["pickle_grid"] = np.asarray([again._mesh.n_data, again._mesh.n_model])
    out["pickle_predict"] = again.predict(_data_of(CKPT))

    # a (1, 2) grid on ranks 0 and 1 (every rank enters new_group)
    pair = dist.new_group([0, 1])
    if rank < 2:
        g = make_grid_mesh(1, 2, group=pair, device="cpu")
        out["pair"] = XPySom(*TRAIN["shape"], **TRAIN["kw"], **CPU, mesh=g).train(
            _data_of(TRAIN), TRAIN["epochs"]).get_weights()
    out["resolved"] = np.asarray(resolve_mesh(meshes["2x2"]) is meshes["2x2"])
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------------

import pytest  # noqa: E402

from xpysom_dask_tpu import XPySom as JaxSom  # noqa: E402
from xpysom_dask_tpu_torch import XPySom  # noqa: E402
from xpysom_dask_tpu_torch.parallel import grid_sharded as gs  # noqa: E402
from xpysom_dask_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # a grid against one device or JAX's grid (tests/test_grid_sharded.py)
TIMEOUT_S = 180


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four gloo workers once; every rank's results. A worker that
    fails or hangs fails the fixture, and all are killed at the
    timeout."""
    root = tmp_path_factory.mktemp("grid")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                          str(WORLD), str(root)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    out = []
    for r in range(WORLD):
        with np.load(root / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _jax_grid(grid):
    from xpysom_dask_tpu.parallel.grid_sharded import make_grid_mesh

    return make_grid_mesh(*GRIDS[grid])


def _port(cfg, **kw):
    return XPySom(*cfg["shape"], **cfg["kw"], **CPU, **kw)


def _jax(cfg, **kw):
    return JaxSom(*cfg["shape"], **cfg["kw"], **kw)


def test_workers_join_the_grid_over_gloo_without_jax(ranks):
    for r, res in enumerate(ranks):
        assert str(res["backend"]) == "gloo"
        assert not bool(res["jax_imported"]) and bool(res["resolved"])
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(res["layout_2x2"], [r, 4, i, 2, j, 2])
        np.testing.assert_array_equal(res["layout_1x4"], [r, 4, 0, 1, r, 4])
        for bad, need in (("3x3", 9), ("1x2", 2)):
            msg = str(res[f"size_error_{bad}"])
            assert f"needs {need} processes" in msg and "has 4" in msg and "torchrun" in msg


def test_resolve_grid_mesh_in_one_process():
    one = port_mesh.resolve_mesh((1, 1), "cpu")
    assert isinstance(one, port_mesh.GridMesh) and (one.n_data, one.n_model) == (1, 1)
    assert port_mesh.resolve_mesh(one) is one and port_mesh.is_grid_mesh(one)
    with pytest.raises(ValueError, match="needs 4 processes and its process group has 1"):
        port_mesh.resolve_mesh((2, 2), "cpu")
    jax_like = type("Grid", (), {"axis_names": ("data", "model")})()
    with pytest.raises(TypeError, match="make_grid_mesh"):
        port_mesh.resolve_mesh(jax_like, "cpu")
    with pytest.raises(ValueError, match="both sizes must be >= 1"):
        port_mesh.make_grid_mesh(0, 1, device="cpu")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_sharded_train_matches_single(ranks, grid):
    data = _data_of(TRAIN)
    single = _port(TRAIN).train(data, TRAIN["epochs"]).get_weights()
    ref = _jax(TRAIN, mesh=_jax_grid(grid)).train(data, TRAIN["epochs"])._weights
    for res in ranks:
        np.testing.assert_allclose(res[f"train_{grid}"], single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"train_{grid}"], ref, rtol=RTOL, atol=ATOL)


def test_device_mesh_grid_is_the_pair_grid_bitwise(ranks):
    for res in ranks:
        np.testing.assert_array_equal(_bits(res["device_mesh"]), _bits(res["train_2x2"]))


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_grid_activations_and_modes_match_single(ranks, name):
    """Cosine, manhattan and odd p search without a centre, even p and the
    modes with the full codebook's: every shard's values are comparable."""
    single = _port(TRAIN, **ACTIVATIONS[name]).train(_data_of(TRAIN), 2).get_weights()
    for res in ranks:
        np.testing.assert_allclose(res[f"act_{name}"], single, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_sharded_inference_matches_single(ranks, grid):
    x = _data_of(INFER)
    single = _port(INFER)
    ref = _jax(INFER, mesh=_jax_grid(grid))
    for res in ranks:
        np.testing.assert_array_equal(res[f"predict_{grid}"], single.predict(x))
        np.testing.assert_array_equal(res[f"predict_{grid}"], ref.predict(x))
        np.testing.assert_array_equal(res[f"winner_{grid}"], np.asarray(single.winner(x[:3])))
        np.testing.assert_array_equal(res[f"quantization_{grid}"], single.quantization(x[:10]))
        np.testing.assert_array_equal(res[f"response_{grid}"], single.activation_response(x))
        np.testing.assert_allclose(res[f"qe_{grid}"], single.quantization_error(x), rtol=1e-6)
        np.testing.assert_allclose(res[f"qe_{grid}"], ref.quantization_error(x), rtol=1e-6)
        np.testing.assert_allclose(res[f"te_{grid}"], single.topographic_error(x), rtol=1e-6)
        np.testing.assert_allclose(res[f"te_{grid}"], ref.topographic_error(x), rtol=1e-6)


def test_shard_operand_is_the_full_search_columns_bitwise(ranks):
    """A shard centres by the full codebook's mean: its packed ``W_aug``
    columns are the single-device search's, bit for bit (a shard's own
    mean would shift every value, and the merge would compare values of
    different searches)."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kbmu

    model = _port(INFER)
    full = kbmu.PackedCodebook(model._device_weights().reshape(-1, INFER["shape"][2]))
    rows = INFER["shape"][0] * INFER["shape"][1] // 4
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(_bits(res["shard_center"]), _bits(full.center.numpy()))
        want = full.w_aug[:, r * rows:(r + 1) * rows].contiguous().view(torch.int16).numpy()
        np.testing.assert_array_equal(res["shard_w_aug"], want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_sharded_model_only_mesh(ranks, grid):
    data = _data_of(MODEL_ONLY)
    single = _port(MODEL_ONLY).train(data, MODEL_ONLY["epochs"]).get_weights()
    ref = _jax(MODEL_ONLY, mesh=_jax_grid(grid)).train(data, MODEL_ONLY["epochs"])._weights
    for res in ranks:
        np.testing.assert_allclose(res[f"model_only_{grid}"], single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res[f"model_only_{grid}"], ref, rtol=RTOL, atol=ATOL)


def test_grid_sharded_verbose_epoch_path(ranks):
    data = _data_of(VERBOSE)
    single = _port(VERBOSE).train(data, VERBOSE["epochs"]).get_weights()
    ref = _jax(VERBOSE, mesh=_jax_grid("2x2")).train(data, VERBOSE["epochs"], verbose=True)
    for res in ranks:
        np.testing.assert_allclose(res["verbose"], single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["verbose"], ref._weights, rtol=RTOL, atol=ATOL)


def test_grid_sharded_tie_breaking_first_index(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["tie_all"], [0, 0])
        np.testing.assert_array_equal(res["tie_deep"], [2, 1])


@pytest.mark.parametrize("topology", ["rectangular", "hexagonal"])
def test_grid_sharded_topographic_error_exact(ranks, topology):
    x = _data(TE["n"], 3, TE["seed"])
    kw = dict(random_seed=4, n_parallel=64, topology=topology)
    untrained = XPySom(8, 8, 3, **kw, **CPU).topographic_error(x)
    trained = XPySom.from_numpy(ranks[0][f"te_weights_{topology}"], **kw, **CPU)
    te1 = trained.topographic_error(x)
    jax_trained = JaxSom(8, 8, 3, **kw, mesh=_jax_grid("2x2"))
    jax_trained._weights = ranks[0][f"te_weights_{topology}"].astype(np.float64)
    assert jax_trained.topographic_error(x) == te1
    tied = XPySom(8, 8, 3, random_seed=5, **CPU)
    tied._weights = np.zeros((8, 8, 3))
    te_tied = tied.topographic_error(x)
    for res in ranks:
        for grid in GRIDS:
            assert float(res[f"te0_{topology}_{grid}"]) == untrained
            assert float(res[f"te1_{topology}_{grid}"]) == te1
            assert float(res[f"te_tied_{grid}"]) == te_tied


def test_grid_te_validation_and_tiny_map_fallback(ranks):
    ref = JaxSom(2, 1, 5, sigma=1.0, random_seed=3).topographic_error(_data(200, 5, 2))
    one = XPySom(2, 1, 5, sigma=1.0, random_seed=3, **CPU).topographic_error(_data(200, 5, 2))
    for res in ranks:
        assert "requires a square map" in str(res["hex_error"])
        assert "needs ≥2 codebook rows per model shard (got 1)" in str(res["rows_error"])
        assert float(res["te_tiny"]) == one
        assert float(res["te_tiny"]) == pytest.approx(ref)


def test_grid_mesh_validation(ranks):
    for res in ranks:
        assert "grid X=5 must divide evenly over 4 model shards" in str(res["x_error"])
        assert "1-D data-parallel meshes only" in str(res["pop_error"])


def test_grid_sharded_streaming_matches_single(ranks):
    data = _data_of(STREAM)
    single = _port(STREAM).train(data, STREAM["epochs"]).get_weights()
    ref = _jax(STREAM).train(data, STREAM["epochs"])._weights
    for res in ranks:
        np.testing.assert_allclose(res["stream"], single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["stream"], ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_multihost_grid_streaming_matches_jax_oracle(ranks, grid):
    """Each rank streams a different, unequally sized slice; the grid's
    host-gather gives each data index its rows, and the result is the
    single-device resident run on the concatenation."""
    import jax.numpy as jnp
    from xpysom_dask_tpu import core as jcore

    full, w0 = _mh_inputs()
    chunks, mask, _ = jcore.chunk_data(full, MH_STREAM["chunk"])
    ref = jcore.make_train_fn(jcore.SomSpec(**SPEC), MH_STREAM["epochs"])(
        jnp.asarray(w0), jnp.asarray(chunks), jnp.asarray(mask), jnp.int32(0),
        jnp.int32(MH_STREAM["epochs"]))
    for res in ranks:
        np.testing.assert_allclose(res[f"mh_stream_{grid}"], np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def test_grid_statistics_match_one_process(ranks):
    """The port has no split scatter: the twin of the split-scatter grid
    parity holds the (2, 2) grid's gathered statistics against one
    process's, and its training against JAX's (2, 2) grid."""
    x = _data_of(STATS)
    ref = _jax(STATS, mesh=_jax_grid("2x2")).train(x, STATS["epochs"])._weights
    for res in ranks:
        np.testing.assert_array_equal(res["stats_grid"][:, -1], res["stats_one"][:, -1])
        np.testing.assert_allclose(res["stats_grid"][:, :-1], res["stats_one"][:, :-1],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["stats_train"], ref, rtol=RTOL, atol=ATOL)


def test_autotune_times_the_nodes_of_a_shard(ranks):
    for res in ranks:
        np.testing.assert_array_equal(res["tune_shape"], [512, 8 * 4 // 2])


def test_grid_checkpoint_resumes_bitwise(ranks):
    x = _data_of(CKPT)
    single = _port(CKPT).train(x, 2).get_weights()
    ref = _jax(CKPT).train(x, 2)._weights
    for res in ranks:
        np.testing.assert_allclose(res["ckpt_span"], single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["ckpt_span"], ref, rtol=RTOL, atol=ATOL)
        assert int(res["ckpt_epoch"]) == 2
        np.testing.assert_array_equal(_bits(res["ckpt_file"]), _bits(res["ckpt_part"]))
        np.testing.assert_array_equal(_bits(res["ckpt_resumed"]), _bits(res["ckpt_full"]))


def test_pickle_of_a_grid_model(ranks):
    x = _data_of(CKPT)
    for res in ranks:
        np.testing.assert_array_equal(res["pickle_grid"], [2, 2])
        loaded = pickle.loads(res["pickle"].tobytes())
        assert loaded._mesh is None and loaded._mesh_arg is None
        np.testing.assert_array_equal(_bits(loaded.get_weights()), _bits(res["ckpt_part"]))
        np.testing.assert_array_equal(loaded.predict(x), res["pickle_predict"])


def test_grid_on_a_subgroup(ranks):
    single = _port(TRAIN).train(_data_of(TRAIN), TRAIN["epochs"]).get_weights()
    np.testing.assert_array_equal(_bits(ranks[0]["pair"]), _bits(ranks[1]["pair"]))
    np.testing.assert_allclose(ranks[0]["pair"], single, rtol=RTOL, atol=ATOL)


def test_ranks_hold_bitwise_equal_codebooks(ranks):
    keys = [k for k in ranks[0] if ranks[0][k].dtype == np.float32 and k != "pair"]
    assert len(keys) > 20
    for k in keys:
        for res in ranks[1:]:
            np.testing.assert_array_equal(_bits(ranks[0][k]), _bits(res[k]), err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(topology="hexagonal"),
                                dict(activation_distance="manhattan"),
                                dict(activation_distance="norm_p",
                                     activation_distance_kwargs={"p": 4})],
                         ids=["rect", "hex", "manhattan", "norm_p4"])
def test_one_by_one_grid_is_the_single_device_path_bit_for_bit(kw):
    x = _data_of(CKPT)
    grid = XPySom(6, 6, 4, random_seed=11, n_parallel=32, mesh=(1, 1), **CPU, **kw).train(x, 3)
    none = XPySom(6, 6, 4, random_seed=11, n_parallel=32, **CPU, **kw).train(x, 3)
    assert isinstance(grid._mesh, port_mesh.GridMesh) and "GridMesh(rank=0" in repr(grid)
    np.testing.assert_array_equal(_bits(grid.get_weights()), _bits(none.get_weights()))
    np.testing.assert_array_equal(grid.predict(x), none.predict(x))
    assert grid.quantization_error(x) == none.quantization_error(x)
    assert grid.topographic_error(x) == none.topographic_error(x)


# -- the merge, in one process ------------------------------------------------------


def _jax_merge(vals, idxs):
    """JAX's _global_bmu (over a stack) and _lexmin on the same candidates."""
    import jax.numpy as jnp
    from xpysom_dask_tpu.parallel.grid_sharded import _lexmin

    v, i = _lexmin(jnp.asarray(vals.T), jnp.asarray(idxs.T))
    gmin = jnp.min(jnp.asarray(vals), axis=0)
    cand = jnp.where(jnp.asarray(vals) == gmin, jnp.asarray(idxs), 2**31 - 1)
    assert np.array_equal(np.asarray(jnp.min(cand, axis=0)), np.asarray(i))
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("case", ["across_boundaries", "signed_zero", "all_tied", "random"])
def test_merge_is_jax_lexmin(case):
    rng = np.random.RandomState(3)
    k, n = 4, 64
    idxs = (np.arange(k)[:, None] * 100 + rng.randint(0, 100, (k, n))).astype(np.int32)
    if case == "across_boundaries":
        vals = rng.randint(0, 3, (k, n)).astype(np.float32) - 1.0
    elif case == "signed_zero":
        vals = np.where(rng.rand(k, n) < 0.5, -0.0, 0.0).astype(np.float32)
        vals[:, ::7] = 1.0
    elif case == "all_tied":
        vals = np.full((k, n), 0.25, np.float32)
    else:
        vals = rng.randn(k, n).astype(np.float32)
    v, i = gs.lexmin(torch.from_numpy(vals), torch.from_numpy(idxs))
    jv, ji = _jax_merge(vals, idxs)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(v.numpy(), jv)  # -0.0 == +0.0 here, as in JAX
    if case == "all_tied":
        np.testing.assert_array_equal(i.numpy(), idxs.min(axis=0))


def test_merge_key_orders_floats():
    vals = torch.tensor([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf])
    keys = gs.merge_key(vals, torch.zeros(8, dtype=torch.int32))
    assert torch.all(keys[1:] >= keys[:-1]) and keys[3] == keys[4]
    back, idx = gs._split_key(gs.merge_key(vals, torch.arange(8, dtype=torch.int32)))
    np.testing.assert_array_equal(back.numpy(), (vals + 0.0).numpy())
    np.testing.assert_array_equal(idx.numpy(), np.arange(8))


# -- tests/test_som.py's planted 5 x 5 x 1 fixture, without a mesh ------------------
# (X = 5 divides by no grid above: the closed-form winners, QE and TE that
# the grid's winner, QE and TE code must keep on one device)


@pytest.fixture
def planted():
    s = XPySom(5, 5, 1, std_coeff=1, **CPU)
    for i in range(5):
        for j in range(5):
            np.testing.assert_almost_equal(1.0, np.linalg.norm(s._weights[i, j]))
    s._weights = np.zeros((5, 5, 1))
    s._weights[2, 3] = 5.0
    s._weights[1, 1] = 2.0
    return s


@pytest.mark.parametrize("kw", [dict(neighborhood_function="boooom"),
                                dict(activation_distance="ridethewave"),
                                dict(topology="dodecahedral")],
                         ids=["neighborhood", "distance", "topology"])
def test_planted_unavailable_options(kw):
    with pytest.raises(ValueError):
        XPySom(5, 5, 1, **CPU, **kw)


def test_planted_hex_triangle_warns_then_raises():
    with pytest.raises(ValueError):
        with pytest.warns(Warning, match="triangle"):
            XPySom(5, 5, 1, topology="hexagonal", neighborhood_function="triangle", **CPU)


def test_planted_win_map_and_labels_map(planted):
    winners = planted.win_map([[5.0], [2.0]])
    assert winners[(2, 3)][0] == [5.0]
    assert winners[(1, 1)][0] == [2.0]
    labels_map = planted.labels_map([[5.0], [2.0]], ["a", "b"])
    assert labels_map[(2, 3)]["a"] == 1
    assert labels_map[(1, 1)]["b"] == 1
    with pytest.raises(ValueError):
        planted.labels_map([[5.0]], ["a", "b"])


def test_planted_activation_response_and_activate(planted):
    response = planted.activation_response([[5.0], [2.0]])
    assert response[2, 3] == 1 and response[1, 1] == 1 and response.sum() == 2
    assert planted.activate(5.0).argmin() == 13  # unravel(13) = (2, 3)


def test_planted_distance_from_weights(planted):
    data = np.arange(-5, 5).reshape(-1, 1)
    weights = planted._weights.reshape(-1, 1)
    distances = planted.distance_from_weights(data)
    for i in range(len(data)):
        for j in range(len(weights)):
            assert distances[i][j] == np.linalg.norm(data[i] - weights[j])


def test_planted_winner_and_quantization_error(planted):
    assert planted.winner(np.array([5.0])) == (2, 3)
    assert planted.winner(np.array([2.0])) == (1, 1)
    assert planted.quantization_error([[5], [2]]) == 0.0
    assert planted.quantization_error([[4], [1]]) == 1.0


@pytest.mark.parametrize("topology", ["rectangular", "hexagonal"])
def test_planted_topographic_error(topology):
    s = XPySom(5, 5, 1, topology=topology, std_coeff=1, **CPU)
    s._weights = np.zeros((5, 5, 1))
    s._weights[2, 3] = 5.0
    # 5 has bmu_1 = (2, 3), bmu_2 = (2, 4): adjacent
    s._weights[2, 4] = 6.0
    # 15 has bmu_1 = (4, 4), bmu_2 = (0, 0): not adjacent
    s._weights[4, 4] = 15.0
    s._weights[0, 0] = 14.0
    assert s.topographic_error([[5]]) == 0.0
    assert s.topographic_error([[15]]) == 1.0
