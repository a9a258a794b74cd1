"""Gradient compression of the port (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``).

* ``quantize_int8`` / ``dequantize_int8`` / ``compress_grads_tree`` on
  seeded numpy draws: q bitwise, the scale within one ulp (measured: equal;
  both divide ``max|x|`` by 127 in float32 and round half to even);
* ``compressed_psum_with_feedback`` on gloo groups of 1, 2 and 4 ranks
  (processes running this file), three rounds of error feedback: each
  rank's sum against the reference's building blocks applied per block and
  the dequantised blocks summed in rank order in float64, within ``W`` ulps
  of float32 times the sum of the blocks' magnitudes (the port sums them in
  float32), and the residuals bitwise.  The reference's own harness needs
  W devices under ``shard_map``, which this process does not have.
"""
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

WORLDS = (1, 2, 4)
ROUNDS, ROWS, COLS = 3, 4, 33
JOIN_S = 60


def _draws(world):
    """Per round, the stacked (world * ROWS, COLS) float32 gradients, with
    magnitudes spread over decades."""
    rng = np.random.default_rng(world)
    return [(rng.normal(size=(world * ROWS, COLS))
             * 10.0 ** rng.integers(-3, 3, size=(world * ROWS, 1))).astype(np.float32)
            for _ in range(ROUNDS)]


def _worker(world, rank, port, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_sample_mesh
    from repro_torch.optim.compression import compressed_psum_with_feedback

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_sample_mesh(device="cpu", axis="data")
        err = torch.zeros(ROWS, COLS)
        got = []
        for x in _draws(world):
            block = torch.from_numpy(x[rank * ROWS:(rank + 1) * ROWS])
            total, err = compressed_psum_with_feedback(mesh, "data", block, err)
            got.append((total, err))
        torch.save(got, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def groups():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs = []
        for world in WORLDS:
            port = _free_port()
            procs += [(world, subprocess.Popen(
                [sys.executable, HERE, str(world), str(r), str(port),
                 os.path.join(tmp, f"w{world}")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)) for r in range(world)]
        logs, alive = [], []
        for world, p in procs:
            try:
                logs.append(p.communicate(timeout=JOIN_S)[0].decode()[-2000:])
            except subprocess.TimeoutExpired:
                alive.append(world)
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert not alive, f"ranks of worlds {alive} still alive after {JOIN_S} s"
        assert all(p.returncode == 0 for _, p in procs), "\n".join(logs)
        return {w: [torch.load(os.path.join(tmp, f"w{w}.{r}")) for r in range(w)]
                for w in WORLDS}


def _x(seed, shape=(64, 17)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 10.0 ** rng.integers(-4, 4)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_dequantize_equal_the_references(seed):
    from repro.optim import compression as jc
    from repro_torch.optim import compression as tc

    x = _x(seed)
    jq, js = jc.quantize_int8(x)
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert abs(ts.item() - float(js)) <= np.spacing(np.float32(js))
    assert np.array_equal(tc.dequantize_int8(tq, ts).numpy(),
                          np.asarray(jc.dequantize_int8(jq, js)))


def test_compress_grads_tree_equals_the_reference():
    from repro.optim import compression as jc
    from repro_torch.optim import compression as tc

    grads = {"w": _x(5), "b": _x(6, (17,)), "deep": [_x(7, (3, 4, 5))]}
    errs = {"w": _x(8) * 1e-3, "b": _x(9, (17,)) * 1e-3, "deep": [_x(10, (3, 4, 5)) * 1e-3]}
    jg, je = jc.compress_grads_tree(grads, errs)
    to_t = lambda t: {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)  # noqa: E731
                          else torch.from_numpy(v)) for k, v in t.items()}
    tg, te = tc.compress_grads_tree(to_t(grads), to_t(errs))
    for name in ("w", "b"):
        assert np.array_equal(tg[name].numpy(), np.asarray(jg[name]))
        assert np.array_equal(te[name].numpy(), np.asarray(je[name]))
    assert np.array_equal(tg["deep"][0].numpy(), np.asarray(jg["deep"][0]))
    assert np.array_equal(te["deep"][0].numpy(), np.asarray(je["deep"][0]))


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_with_feedback_equals_the_references_blocks(groups, world):
    """Three rounds: every rank returns the same sum; it equals the
    reference's quantise / dequantise per block, summed in rank order in
    float64, within W float32 ulps of the blocks' magnitudes; each rank's
    residual is the reference's bitwise and feeds the next round."""
    from repro.optim import compression as jc

    ranks = groups[world]
    errs = [np.zeros((ROWS, COLS), np.float32) for _ in range(world)]
    for rnd, x in enumerate(_draws(world)):
        deq, mags = [], np.zeros((ROWS, COLS))
        for r in range(world):
            val = x[r * ROWS:(r + 1) * ROWS] + errs[r]
            q, scale = jc.quantize_int8(val)
            d = np.asarray(jc.dequantize_int8(q, scale))
            deq.append(d.astype(np.float64))
            mags += np.abs(d)
            errs[r] = val - d
        want = deq[0]
        for d in deq[1:]:
            want = want + d
        tol = world * np.finfo(np.float32).eps * mags
        for r, got in enumerate(ranks):
            total, err = got[rnd]
            assert torch.equal(total, ranks[0][rnd][0])
            assert np.all(np.abs(total.numpy() - want) <= tol), (rnd, r)
            assert np.array_equal(err.numpy(), errs[r]), (rnd, r)


def test_launch_and_optim_import_no_jax():
    """Every module of ``repro_torch.launch`` and ``repro_torch.optim``
    imports with ``jax`` blocked."""
    code = ("import pkgutil, importlib, sys; sys.modules['jax'] = None; "
            "import repro_torch.launch as l, repro_torch.optim as o; "
            "names = [p.__name__ + '.' + m.name for p in (l, o) "
            "for m in pkgutil.iter_modules(p.__path__)]; "
            "[importlib.import_module(n) for n in names]; "
            "assert {'repro_torch.launch.mesh', 'repro_torch.optim.compression'} <= set(names); "
            "bad = sorted(m for m, mod in sys.modules.items() "
            "if mod is not None and m.startswith(('jax', 'repro.'))); "
            "print(names, bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
