"""Data-parallel training of the PyTorch port across processes, on the CPU.

Two ``torch.distributed`` processes on gloo (a ``file://`` store under the
test's temporary directory) run this file as a script, once for the
module: ``python tests/test_torch_distributed.py --worker RANK WORLD DIR``.
The worker imports torch and the port only, never JAX; it drives every
data-parallel path on inputs made with numpy from fixed seeds and writes
its results to ``DIR/rank{RANK}.npz``. The tests read those results and
hold them against the JAX package's own data-parallel path on the same
inputs (``conftest.py`` gives JAX 8 virtual CPU devices, so
``make_data_mesh(2)`` runs in this process), against the port without a
mesh, and rank against rank.

Tolerances: the statistics as ``tests/multihost_worker.py`` holds JAX's
(``cnt`` exact, ``S`` within rtol 1e-6, atol 1e-6); training, against
JAX's mesh and the port's single process, as ``tests/test_sharded.py``
holds a mesh against one device (rtol 1e-4, atol 1e-5); the batched
population epoch at rtol 1e-5, atol 1e-6, as
``tests/test_population.py`` holds JAX's mesh (both one fp32 GEMM); QE and
TE at rtol 1e-6. Bitwise: the ranks'
codebooks, the checkpoint file against them, the resumed run against the
uninterrupted one, a world of one against no mesh, and gathered winners
against one process's.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CPU = dict(device="cpu")
SPEC = dict(x=6, y=5, input_len=4, sigma=3.0, sigmaN=1.0, learning_rate=0.5,
            learning_rateN=0.01)
RECT = dict(shape=(6, 6, 4), kw=dict(random_seed=1, n_parallel=64), n=1000, seed=0, epochs=4)
HEX = dict(shape=(5, 5, 3), kw=dict(topology="hexagonal", random_seed=4, n_parallel=32),
           n=256, seed=5, epochs=3)
INFER = dict(shape=(5, 7, 5), kw=dict(random_seed=2, n_parallel=32), n=333, seed=3)
CKPT = dict(shape=(5, 5, 4), kw=dict(random_seed=11, n_parallel=32), n=300, seed=7)
POP = dict(args=(2, 5, 4, 8), kw=dict(sigma=[1.0, 2.0], learning_rate=[0.4, 0.6],
                                      random_seed=2, n_parallel=64), n=300, seed=3)
# ShardedFileSource over three files: files[0::2] gives rank 0 180 rows,
# files[1::2] rank 1 120 (tests/multihost_worker.py's uneven split)
SHARD_ROWS = (100, 120, 80)
STREAM = dict(chunk=16, superbatch_rows=64, epochs=3)


def _data(n, d, seed):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def _stats_inputs():
    """240 rows: 15 chunks of 16, padded to 16, so the last rank's last
    chunk is fully masked (its partial must be exact zeros)."""
    rng = np.random.RandomState(0)
    data = rng.rand(240, SPEC["input_len"]).astype(np.float32)
    w = rng.rand(SPEC["x"], SPEC["y"], SPEC["input_len"]).astype(np.float32)
    return data, w


def _stream_inputs():
    rng = np.random.RandomState(8)
    full = rng.rand(sum(SHARD_ROWS), SPEC["input_len"]).astype(np.float32)
    w0 = rng.rand(SPEC["x"], SPEC["y"], SPEC["input_len"]).astype(np.float32)
    return full, w0


def _shard_files(root):
    return [os.path.join(root, f"shard{i}.f32") for i in range(len(SHARD_ROWS))]


def _write_shards(root):
    full, _ = _stream_inputs()
    for f, (a, b) in zip(_shard_files(root), zip(np.cumsum((0,) + SHARD_ROWS[:-1]),
                                                  np.cumsum(SHARD_ROWS))):
        full[a:b].tofile(f)


# -- the worker ---------------------------------------------------------------------


def _worker(rank, world, root):
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from xpysom_dask_tpu_torch import SomPopulation, XPySom
    from xpysom_dask_tpu_torch.core import SomSpec, chunk_data, make_stats_fn
    from xpysom_dask_tpu_torch.parallel import (
        ArraySource,
        ShardedFileSource,
        initialize_multihost,
        make_data_mesh,
        put_with_sharding,
        resolve_mesh,
        train_streaming,
    )

    initialize_multihost(f"file://{root}/rendezvous", world, rank, **CPU)
    out = {"backend": np.asarray(dist.get_backend())}
    mesh = resolve_mesh("auto", "cpu")
    out["mesh"] = np.asarray([mesh.rank, mesh.world, resolve_mesh(world, "cpu").world,
                              resolve_mesh(dist.group.WORLD, "cpu").world])
    try:
        make_data_mesh(world + 1, device="cpu")
    except ValueError as exc:
        out["int_error"] = np.asarray(str(exc))

    def som(cfg, **kw):
        return XPySom(*cfg["shape"], **cfg["kw"], **CPU, **kw)

    def data_of(cfg):
        return _data(cfg["n"], cfg["shape"][2], cfg["seed"])

    # statistics of this rank's block, reduced
    data, w = _stats_inputs()
    chunks, mask, _ = chunk_data(data, 16, multiple_of=world)
    stats = make_stats_fn(SomSpec(**SPEC), mesh)(
        torch.from_numpy(w), put_with_sharding(chunks, mesh), put_with_sharding(mask, mesh))
    out["stats"] = stats.numpy()

    # resident training, rectangular and hexagonal (over the group itself)
    for name, cfg, arg in (("rect", RECT, "auto"), ("hex", HEX, dist.group.WORLD)):
        model = som(cfg, mesh=arg).train(data_of(cfg), cfg["epochs"])
        out[f"train_{name}"] = model.get_weights()
    # a pickle keeps a process group as its world size
    out["pickle"] = np.frombuffer(pickle.dumps(model), dtype=np.uint8)
    again = pickle.loads(pickle.dumps(model))
    out["pickle_world"] = np.asarray(again._mesh.world)
    out["pickle_predict"] = again.predict(data_of(HEX))

    # scoring: gathered winners, reduced sums
    model, x = som(INFER, mesh="auto"), data_of(INFER)
    out["predict"] = model.predict(x)
    out["winner"] = np.asarray(model.winner(x[:3]))
    out["quantization"] = model.quantization(x)
    out["qe"] = np.asarray(model.quantization_error(x))
    out["te"] = np.asarray(model.topographic_error(x))
    out["response"] = model.activation_response(x)
    try:
        model.predict(ArraySource(x))
    except NotImplementedError as exc:
        out["stream_predict_error"] = np.asarray(str(exc))

    # use_dask=True is mesh='auto' with the JAX package's warning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = XPySom(4, 4, 2, use_dask=True, random_seed=0, **CPU)
    out["dask_warning"] = np.asarray(" | ".join(str(c.message) for c in caught))
    out["dask_world"] = np.asarray(model._mesh.world)
    out["dask_w"] = model.train(_data(64, 2, 1), 2).get_weights()

    # checkpoint written by rank 0 at epoch 2, reloaded by every rank, resumed
    ck, x = os.path.join(root, "ck.npz"), data_of(CKPT)
    out["ckpt_full"] = som(CKPT, mesh="auto").train(x, 4).get_weights()
    part = som(CKPT, mesh="auto").train(x, 4, iter_end=2, checkpoint_path=ck,
                                        checkpoint_every=1)
    out["ckpt_part"] = part.get_weights()
    with np.load(ck) as z:  # in place as soon as save_checkpoint returns
        out["ckpt_file"] = z["weights"]
    loaded = XPySom.load_checkpoint(ck, mesh="auto", **CPU)
    out["ckpt_epoch"] = np.asarray(loaded._checkpoint_epoch)
    out["ckpt_resumed"] = loaded.train(x, 4, iter_beg=loaded._checkpoint_epoch).get_weights()

    # streamed training from files[rank::world], ragged row counts
    _, w0 = _stream_inputs()
    src = ShardedFileSource(_shard_files(root), SPEC["input_len"], mesh=mesh)
    out["stream_rows"] = np.asarray(len(src))
    out["stream_w"] = train_streaming(
        SomSpec(**SPEC), w0, src, STREAM["epochs"], chunk=STREAM["chunk"],
        superbatch_rows=STREAM["superbatch_rows"], mesh=mesh)

    # population: resident sweeps, streamed (each rank its own half), QE
    x = _data(POP["n"], POP["args"][3], POP["seed"])
    for strategy in ("fused", "batched"):
        pop = SomPopulation(*POP["args"], **POP["kw"], mesh="auto", **CPU)
        out[f"pop_{strategy}"] = pop.train(x, 2, iter_end=1, strategy=strategy).weights
    out["pop_qe"] = pop.quantization_errors(x)
    pop = SomPopulation(*POP["args"], **POP["kw"], mesh="auto", **CPU)
    pop._superbatch_rows = lambda: 64
    half = POP["n"] // world
    out["pop_streamed"] = pop.train(ArraySource(x[rank * half:(rank + 1) * half]), 2,
                                    iter_end=1).weights

    # spans under a profiler: this rank's block uploaded, one all_reduce an epoch
    from xpysom_dask_tpu_torch.utils import profiling

    model, x = som(RECT, mesh="auto"), data_of(RECT)
    with profiling.trace(os.path.join(root, f"trace{rank}")):
        model.train(x, 2)
        model.quantization_error(x)
    recs = profiling.recorded()[0]
    out["span_names"] = np.asarray([r["name"] for r in recs])
    out["span_bytes"] = np.asarray([r["counts"].get("bytes", -1) for r in recs])
    out["span_calls"] = np.asarray([r["call"] for r in recs])

    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------------

import pytest  # noqa: E402

from xpysom_dask_tpu import SomPopulation as JaxPop  # noqa: E402
from xpysom_dask_tpu import XPySom as JaxSom  # noqa: E402
from xpysom_dask_tpu_torch import SomPopulation, XPySom  # noqa: E402
from xpysom_dask_tpu_torch.core import chunk_data as port_chunk_data  # noqa: E402
from xpysom_dask_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5  # a mesh against one device or JAX's mesh (tests/test_sharded.py)
TIMEOUT_S = 180


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two gloo workers once; every rank's results. A worker that
    fails or hangs fails the fixture, and both are killed at the
    timeout."""
    root = tmp_path_factory.mktemp("dist")
    _write_shards(str(root))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
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


def _port_single(cfg, **kw):
    return XPySom(*cfg["shape"], **cfg["kw"], **CPU, **kw)


def _jax(cfg, **kw):
    return JaxSom(*cfg["shape"], **cfg["kw"], **kw)


def _data_of(cfg):
    return _data(cfg["n"], cfg["shape"][2], cfg["seed"])


def test_workers_join_over_gloo_without_jax(ranks):
    for r, res in enumerate(ranks):
        assert str(res["backend"]) == "gloo"
        np.testing.assert_array_equal(res["mesh"], [r, WORLD, WORLD, WORLD])
        assert not bool(res["jax_imported"])


def test_resolve_mesh_cases(ranks):
    assert port_mesh.resolve_mesh(None) is None and port_mesh.resolve_mesh(False) is None
    for arg in ("auto", True, 1):
        m = port_mesh.resolve_mesh(arg, "cpu")
        assert (m.rank, m.world, m.device) == (0, 1, torch.device("cpu"))
    assert port_mesh.resolve_mesh(m) is m
    with pytest.raises(ValueError, match="initialize_multihost.*torchrun"):
        port_mesh.resolve_mesh(2, "cpu")
    # a (data, model) grid: a pair needs its n_data * n_model processes, and
    # a JAX mesh cannot drive the port (tests/test_torch_grid_sharded.py)
    with pytest.raises(ValueError, match="needs 4 processes.*torchrun"):
        port_mesh.resolve_mesh((2, 2), "cpu")
    with pytest.raises(TypeError, match="make_grid_mesh"):
        port_mesh.resolve_mesh(type("Grid", (), {"axis_names": ("data", "model")})(), "cpu")
    with pytest.raises(TypeError):
        port_mesh.resolve_mesh(3.5, "cpu")
    # across two processes: an int other than the world size names the launchers
    for res in ranks:
        msg = str(res["int_error"])
        assert "mesh=3" in msg and "initialize_multihost" in msg and "torchrun" in msg


def test_initialize_multihost_picks_and_honours_the_backend(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["init_method"])))
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(str(dev)))
    port_mesh.initialize_multihost("localhost:29500", 1, 0)
    port_mesh.initialize_multihost("file:///tmp/x", 1, 0, device="cpu")
    port_mesh.initialize_multihost(None, 1, 0, backend="gloo")
    assert calls == [("nccl", "tcp://localhost:29500"), "cuda:0",
                     ("gloo", "file:///tmp/x"), ("gloo", "env://"), "cuda:0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_mesh.initialize_multihost("localhost:29500", 1, 0)


def test_stats_match_jax_mesh_and_single_process(ranks):
    import jax.numpy as jnp
    from xpysom_dask_tpu import core as jcore
    from xpysom_dask_tpu.parallel.mesh import data_sharding, make_data_mesh

    from xpysom_dask_tpu_torch.core import SomSpec, chunk_data, make_stats_fn

    data, w = _stats_inputs()
    chunks, mask, _ = chunk_data(data, 16, multiple_of=WORLD)
    mesh = make_data_mesh(WORLD)
    s, cnt = jcore.make_stats_fn(jcore.SomSpec(**SPEC), mesh)(
        jnp.asarray(w), jax_put(chunks, data_sharding(mesh)),
        jax_put(mask, data_sharding(mesh)))
    single = make_stats_fn(SomSpec(**SPEC))(
        torch.from_numpy(w), torch.from_numpy(chunks), torch.from_numpy(mask)).numpy()
    for res in ranks:
        got = res["stats"]
        np.testing.assert_array_equal(got[:, -1], single[:, -1])
        np.testing.assert_array_equal(got[:, -1], np.asarray(cnt))
        np.testing.assert_allclose(got[:, :-1], single[:, :-1], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[:, :-1], np.asarray(s), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_bits(ranks[0]["stats"]), _bits(ranks[1]["stats"]))


def jax_put(arr, sharding):
    import jax

    return jax.device_put(arr, sharding)


@pytest.mark.parametrize("name,cfg", [("rect", RECT), ("hex", HEX)], ids=["rect", "hex"])
def test_training_matches_jax_mesh_and_single_process(ranks, name, cfg):
    data = _data_of(cfg)
    single = _port_single(cfg).train(data, cfg["epochs"]).get_weights()
    ref = _jax(cfg, mesh=WORLD).train(data, cfg["epochs"])._weights
    for res in ranks:
        got = res[f"train_{name}"]
        np.testing.assert_allclose(got, single, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_spans_over_a_data_mesh(ranks):
    """Each rank uploads the rows of its half of the chunks (the padding
    and the mask are made on its device), all_reduces the (XY, D+1)
    statistics once an epoch and QE's two sums once; each epoch and QE
    build the search's codebook once."""
    x, y, d = RECT["shape"]
    chunks, _, n = port_chunk_data(_data_of(RECT), RECT["kw"]["n_parallel"], multiple_of=WORLD)
    per = chunks.shape[0] // WORLD * chunks.shape[1]
    for rank, res in enumerate(ranks):
        names, sent = list(res["span_names"]), res["span_bytes"]
        assert names == (["xpysom.train", "xpysom.prepare"] + ["xpysom.upload"] * 2
                         + ["xpysom.epoch", "xpysom.codebook", "xpysom.all_reduce"] * 2
                         + ["xpysom.fetch"]
                         + ["xpysom.quantization_error", "xpysom.prepare"] + ["xpysom.upload"] * 2
                         + ["xpysom.codebook", "xpysom.all_reduce", "xpysom.fetch"])
        qe = names.index("xpysom.quantization_error")
        assert len(set(res["span_calls"][:qe])) == 1 and len(set(res["span_calls"][qe:])) == 1
        uploads = [b for n, b in zip(names, sent) if n == "xpysom.upload"]
        mine = min(n, (rank + 1) * per) - min(n, rank * per)
        assert uploads[:2] == [mine * d * 4, x * y * d * 4]
        assert all(b == -1 for n, b in zip(names, sent) if n == "xpysom.all_reduce")


def test_ranks_hold_bitwise_equal_codebooks(ranks):
    keys = ["stats", "train_rect", "train_hex", "quantization", "dask_w", "ckpt_full",
            "ckpt_part", "ckpt_file", "ckpt_resumed", "stream_w", "pop_fused", "pop_batched",
            "pop_qe", "pop_streamed"]
    for k in keys:
        np.testing.assert_array_equal(_bits(ranks[0][k]), _bits(ranks[1][k]), err_msg=k)


def test_inference_gathers_and_reduces_as_one_process(ranks):
    x = _data_of(INFER)
    single = _port_single(INFER)
    ref = _jax(INFER, mesh=WORLD)
    for res in ranks:
        np.testing.assert_array_equal(res["predict"], single.predict(x))
        np.testing.assert_array_equal(res["predict"], ref.predict(x))
        np.testing.assert_array_equal(res["winner"], np.asarray(single.winner(x[:3])))
        np.testing.assert_array_equal(res["quantization"], single.quantization(x))
        np.testing.assert_array_equal(res["response"], single.activation_response(x))
        np.testing.assert_allclose(res["qe"], single.quantization_error(x), rtol=1e-6)
        np.testing.assert_allclose(res["qe"], ref.quantization_error(x), rtol=1e-6)
        np.testing.assert_allclose(res["te"], single.topographic_error(x), rtol=1e-6)
        np.testing.assert_allclose(res["te"], ref.topographic_error(x), rtol=1e-6)
        assert "streaming inference over a multi-host mesh" in str(res["stream_predict_error"])


def test_use_dask_warns_and_trains_over_the_mesh(ranks):
    single = XPySom(4, 4, 2, random_seed=0, **CPU).train(_data(64, 2, 1), 2).get_weights()
    for res in ranks:
        assert "use_dask is deprecated: mapping to mesh='auto'" in str(res["dask_warning"])
        assert int(res["dask_world"]) == WORLD
        np.testing.assert_allclose(res["dask_w"], single, rtol=RTOL, atol=ATOL)


def test_pickle_of_a_mesh_model(ranks):
    """A model over a process group pickles the group as its world size:
    inside the run the mesh resolves again over both processes; in a
    process without the group it cannot, and the model runs without a
    mesh."""
    x = _data_of(HEX)
    for res in ranks:
        assert int(res["pickle_world"]) == WORLD
        loaded = pickle.loads(res["pickle"].tobytes())
        assert loaded._mesh is None and loaded._mesh_arg is None
        np.testing.assert_array_equal(_bits(loaded.get_weights()), _bits(res["train_hex"]))
        np.testing.assert_array_equal(loaded.predict(x), res["pickle_predict"])


def test_multiprocess_checkpoint_resumes_bitwise(ranks):
    for res in ranks:
        assert int(res["ckpt_epoch"]) == 2
        # the file holds the codebook every rank shares, bit for bit
        np.testing.assert_array_equal(_bits(res["ckpt_file"]), _bits(res["ckpt_part"]))
        np.testing.assert_array_equal(_bits(res["ckpt_resumed"]), _bits(res["ckpt_full"]))
    single = _port_single(CKPT).train(_data_of(CKPT), 4).get_weights()
    np.testing.assert_allclose(ranks[0]["ckpt_full"], single, rtol=RTOL, atol=ATOL)


def test_sharded_file_source_uneven_split_matches_jax_oracle(ranks):
    import jax.numpy as jnp
    from xpysom_dask_tpu import core as jcore

    assert [int(r["stream_rows"]) for r in ranks] == [180, 120]
    full, w0 = _stream_inputs()
    chunks, mask, _ = jcore.chunk_data(full, STREAM["chunk"])
    ref = jcore.make_train_fn(jcore.SomSpec(**SPEC), STREAM["epochs"])(
        jnp.asarray(w0), jnp.asarray(chunks), jnp.asarray(mask), jnp.int32(0),
        jnp.int32(STREAM["epochs"]))
    for res in ranks:
        np.testing.assert_allclose(res["stream_w"], np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strategy", ["fused", "batched"])
def test_population_matches_jax_mesh_and_single_process(ranks, strategy):
    x = _data(POP["n"], POP["args"][3], POP["seed"])
    single = SomPopulation(*POP["args"], **POP["kw"], **CPU)
    single.train(x, 2, iter_end=1, strategy=strategy)
    ref = JaxPop(*POP["args"], **POP["kw"], mesh=WORLD)
    ref.train(x, 2, iter_end=1, strategy="serial" if strategy == "fused" else strategy)
    rtol, atol = (RTOL, ATOL) if strategy == "fused" else (1e-5, 1e-6)
    for res in ranks:
        got = res[f"pop_{strategy}"]
        np.testing.assert_allclose(got, single.weights, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, ref.weights, rtol=rtol, atol=atol)
        # a streamed sweep, each rank streaming its own half of the rows
        np.testing.assert_allclose(res["pop_streamed"], res["pop_fused"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["pop_qe"], single.quantization_errors(x), rtol=1e-6)


def test_population_grid_mesh_refused():
    with pytest.raises(ValueError, match="1-D data-parallel meshes only"):
        SomPopulation(2, 4, 4, 6, mesh=(2, 2), **CPU)


def test_world_of_one_is_the_single_device_path_bit_for_bit():
    """A mesh of one process runs no collective: training, winners, QE and
    TE equal the path without a mesh bit for bit."""
    x = _data_of(CKPT)
    one = _port_single(CKPT, mesh="auto").train(x, 3)
    none = _port_single(CKPT).train(x, 3)
    assert one._mesh.world == 1 and "mesh=DataMesh(rank=0, world=1" in repr(one)
    np.testing.assert_array_equal(_bits(one.get_weights()), _bits(none.get_weights()))
    np.testing.assert_array_equal(one.predict(x), none.predict(x))
    assert one.quantization_error(x) == none.quantization_error(x)
    assert one.topographic_error(x) == none.topographic_error(x)
