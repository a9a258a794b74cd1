"""The port's dry run, roofline and report against the JAX reference.

In this process, against ``repro.launch.dryrun`` (imported once the JAX
backend is up, its ``XLA_FLAGS`` put back): ``input_specs`` for every
applicable (arch, shape) at one microbatch and at the cell's own count;
``microbatches_for`` on the ``single`` and ``multi`` meshes at the
reference's 4 GiB and dividing the local batch at the H100's quarter;
``model_flops_for``, the analytic FLOP and I/O helpers and
``_analytic_memory_bytes`` (on a ``(16, 16)`` mesh) exactly;
``attn_impl="stub"``'s attention and Mamba blocks against the reference's
stub (float64 weights; both take norms and the scan in float32);
``report.fmt_row`` against the reference's on a port
record.

A process group is global to its process, so the fake world runs in one
subprocess (:data:`_FAKE_WORLD`, torch only, shared by the module): it
imports the dry run (no JAX, no process group), then on a fake ``(2, 2)``
mesh counts a column- then row-parallel pair (per-rank FLOPs against the
local shards' hand count; one all-reduce and one all-gather's result
bytes, and torch.distributed's own collectives), writes ``run_cell``
records for train, prefill and decode on the dense, hybrid and moe smoke
configs (:data:`RECORD_CELLS`) and refuses a real (gloo) world.
"""
import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import report as jreport
from repro.models import ModelOptions as JModelOptions
from repro.models.layers import attn_block as jattn_block
from repro.models.ssm import mamba_block as jmamba_block
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.mesh import _leaf_spec
from repro_torch.models import ModelOptions
from repro_torch.models.layers import attn_block, init_attn_block
from repro_torch.models.ssm import init_mamba_block, mamba_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB4 = 4 * 2**30


@pytest.fixture(scope="module")
def ref():
    """``repro.launch.dryrun``, which sets ``XLA_FLAGS`` when imported: the
    backend is started first, and the variable is put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref_dryrun

    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return ref_dryrun


class FakeMesh:
    """A mesh by its axis sizes, as both packages' rules read one."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.size = int(np.prod(list(axes.values())))


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}


def _cells(kinds=None):
    for arch in configs.list_archs():
        for shape in configs.ALL_SHAPES:
            if configs.cell_applicable(configs.get_arch(arch), shape)[0] and (
                    kinds is None or shape.kind in kinds):
                yield arch, shape.name


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_microbatches_equal_reference(ref, mesh_kind):
    mesh = MESHES[mesh_kind]
    dp = mesh.size // 16
    for arch, shape in _cells({"train"}):
        jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
        sh = configs.get_shape(shape)
        got = dryrun.microbatches_for(cfg, sh, mesh, budget=GIB4)
        assert got == ref.microbatches_for(jcfg, jconfigs.get_shape(shape), mesh), arch
        k = dryrun.microbatches_for(cfg, sh, mesh)
        assert (sh.global_batch // dp) % k == 0 and k <= got, (arch, k)


def test_input_specs_equal_reference(ref):
    n = 0
    for arch, shape in _cells():
        mb = ref.microbatches_for(jconfigs.get_arch(arch), jconfigs.get_shape(shape),
                                  MESHES["single"])
        for m in sorted({1, mb}):
            want = ref.input_specs(arch, shape, microbatches=m)
            got = dryrun.input_specs(arch, shape, microbatches=m)
            assert sorted(got) == sorted(want), (arch, shape)
            for k, spec in want.items():
                assert got[k].shape == tuple(spec.shape), (arch, shape, k)
                assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(spec.dtype).name
                n += 1
    assert n > 50


def test_model_flops_and_analytic_helpers_equal_reference(ref):
    helpers = ("_attn_flops", "_attn_score_bytes", "_attn_io_bytes", "_ssd_io_bytes",
               "_seq_mix_io_bytes")
    for arch, shape in _cells():
        jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
        sh, jsh = configs.get_shape(shape), jconfigs.get_shape(shape)
        assert dryrun.model_flops_for(cfg, sh) == ref.model_flops_for(jcfg, jsh)
        for name in helpers:
            for b, n_dev in ((1, 256), (sh.global_batch, 512), (3, 1)):
                assert (getattr(dryrun, name)(cfg, b, sh.seq_len, n_dev)
                        == getattr(ref, name)(jcfg, b, jsh.seq_len, n_dev)), (arch, name)


def test_analytic_memory_bytes_equal_reference(ref):
    mesh = MESHES["single"]
    layers = {}
    for arch, shape in _cells():
        jcfg, cfg = jconfigs.get_arch(arch), configs.get_arch(arch)
        if arch not in layers:
            layers[arch] = ref._abstract_layer(jcfg)
        jal = layers[arch]
        jspecs = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _leaf_spec(mesh, path[-1].key, leaf.shape, fsdp=None,
                                          stacked=False), jal)
        al = dryrun._abstract_layer(cfg)
        mb = ref.microbatches_for(jcfg, jconfigs.get_shape(shape), mesh)
        want = ref._analytic_memory_bytes(jcfg, jconfigs.get_shape(shape), mesh,
                                          microbatches=mb, al=jal, l_specs=jspecs)
        got = dryrun._analytic_memory_bytes(cfg, configs.get_shape(shape), mesh,
                                            microbatches=mb, al=al,
                                            l_specs=dryrun._layer_specs(cfg, mesh, False, al))
        assert got == want, (arch, shape)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_decode_cache_constraints_equal_reference(ref, mesh_kind):
    mesh = MESHES[mesh_kind]
    for arch, shape in _cells({"decode"}):
        sh = configs.get_shape(shape)
        want = ref._decode_cache_constraints(jconfigs.get_arch(arch), mesh, sh.global_batch,
                                             sh.seq_len)
        got = dryrun._decode_cache_constraints(configs.get_arch(arch), mesh, sh.global_batch,
                                               sh.seq_len)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


# Float64 weights and inputs, but both packages take their norms, RoPE
# tables, ``dt`` and the scan in float32, so the blocks agree to float32
# rounding (6.5e-7 of values O(1) measured), not to float64's.
STUB_ATOL = 1e-5


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b"])
def test_stub_blocks_equal_reference(arch):
    """``attn_impl="stub"``: the attention block hands its queries through
    and the Mamba block's scan is ``x * dt``, as the reference's (the
    port's weights carried over)."""
    jcfg = jconfigs.get_arch(arch).smoke()
    cfg = configs.get_arch(arch).smoke()
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model))
    key = prng.PRNGKey(1, device="cpu")
    if arch == "zamba2-7b":
        init, block, jblock = init_mamba_block, mamba_block, jmamba_block
    else:
        init, block, jblock = init_attn_block, attn_block, jattn_block
    p = init(cfg, key, torch.float64)
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}
    want = np.asarray(jax.jit(jblock, static_argnums=(0, 3))(
        jcfg, jp, jnp.asarray(x), JModelOptions(attn_impl="stub")))
    with torch.no_grad():
        got = block(cfg, p, torch.from_numpy(x), ModelOptions(attn_impl="stub"))
        real = block(cfg, p, torch.from_numpy(x), ModelOptions())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STUB_ATOL)
    assert np.abs(real.numpy() - want).max() > 1e-3  # the stub path ran


def test_kernels_refuse_fake_tensors():
    """A fake or meta tensor has no data: ``pointer``, through which the LM's
    kernel wrappers hand every operand to a launch, raises before a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels._build import pointer

    with FakeTensorMode():
        fakes = [torch.empty(1, 2, 8, 16), torch.empty(8, device="cuda")]
    for t in fakes + [torch.empty(8, device="meta")]:
        with pytest.raises(RuntimeError, match="no data"):
            pointer(t)
    t = torch.ones(2)
    assert pointer(t).value == t.data_ptr()


# ---------------------------------------------------------------------------
# The fake world (a subprocess of torch alone).
# ---------------------------------------------------------------------------

_FAKE_WORLD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
import repro_torch.launch.dryrun as dryrun
import repro_torch.launch.report, repro_torch.launch.roofline
out = {"import": {"jax": "jax" in sys.modules,
                  "repro": any(m == "repro" or m.startswith("repro.") for m in sys.modules),
                  "process_group": dist.is_initialized()}}

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.launch.roofline import CostCounter, analyze

dryrun.fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
B, D, F = 8, 32, 64
with FakeTensorMode():
    x = torch.empty(B // 2, D, dtype=torch.bfloat16)
    w1 = torch.empty(D, F // 2, dtype=torch.bfloat16)
    w2 = torch.empty(F // 2, D, dtype=torch.bfloat16)
    X = DTensor.from_local(x, mesh, [Shard(0), Replicate()], run_check=False)
    W1 = DTensor.from_local(w1, mesh, [Replicate(), Shard(1)], run_check=False)
    W2 = DTensor.from_local(w2, mesh, [Replicate(), Shard(0)], run_check=False)
    with CostCounter() as pair:
        o = (X @ W1) @ W2
    with CostCounter() as coll:
        r = o.redistribute(mesh, [Shard(0), Replicate()])
        g = r.redistribute(mesh, [Replicate(), Replicate()])
out["pair"] = {"flops": pair.flops, "coll": pair.collective_bytes(),
               "placements": [type(p).__name__ for p in o.placements]}
out["coll"] = coll.collective_bytes()
t = torch.ones(8, 4)  # plain torch.distributed calls, through the c10d ops
with CostCounter() as c10d:
    dist.all_reduce(t)
    dist.all_gather_into_tensor(torch.empty(32, 4), t)
    dist.reduce_scatter_tensor(torch.empty(2, 4), t)
out["c10d"] = c10d.collective_bytes()
out["analyze"] = analyze(c10d, n_devices=4, model_flops=1.0).to_dict()

out["records"] = {}
for arch, layers, kind in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(get_arch(arch).smoke(), n_layers=layers, dtype="bfloat16")
    shape = ShapeSpec(kind, kind, 16 if kind == "decode" else 32, 4)
    out["records"][f"{arch} {kind}"] = dryrun.run_cell(cfg, shape, "single", mesh=mesh)
dist.destroy_process_group()
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0", rank=0, world_size=1)
try:
    dryrun.run_cell("qwen3-1.7b", "train_4k", "single")
    out["refused"] = None
except ValueError as e:
    out["refused"] = str(e)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""

# (arch, layers, kind): run_cell's records on the dense, hybrid (shared
# attention, every 2 layers) and moe smoke configs, for train, prefill and
# decode
RECORD_CELLS = (("qwen3-1.7b", 3, "prefill"), ("zamba2-7b", 4, "train"),
                ("olmoe-1b-7b", 3, "decode"))


@pytest.fixture(scope="module")
def fake_world():
    """What :data:`_FAKE_WORLD` reports, from one subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _FAKE_WORLD, json.dumps(RECORD_CELLS)],
                          cwd=REPO, env=env, text=True, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_import_loads_no_jax_and_no_process_group(fake_world):
    assert fake_world["import"] == {"jax": False, "repro": False, "process_group": False}


def test_per_rank_flops_of_a_column_row_pair(fake_world):
    """(8, 32) @ (32, 64) @ (64, 32) on a (2, 2) mesh: each rank multiplies
    its 4 rows by its 32 of the 64 hidden columns, twice."""
    pair = fake_world["pair"]
    assert pair["flops"] == 2 * (2 * 4 * 32 * 32)  # one rank's local shards
    assert pair["coll"]["count"] == 0  # the row product stays a partial sum
    assert pair["placements"] == ["Shard", "Partial"]


def test_collective_result_bytes(fake_world):
    """The partial sums reduced: an all-reduce of this rank's (4, 32) bf16
    block; then the rows gathered: an all-gather whose result is (8, 32)."""
    coll = fake_world["coll"]
    assert coll == {"all-reduce": 4 * 32 * 2, "all-gather": 8 * 32 * 2, "reduce-scatter": 0,
                    "all-to-all": 0, "collective-permute": 0, "count": 2}


def test_plain_c10d_collectives_and_analyze(ref, fake_world):
    """torch.distributed's own all-reduce, all-gather and reduce-scatter of
    an (8, 4) float32 tensor over 4 ranks: their results' bytes; and
    ``analyze``'s record, with the reference's ``Roofline`` fields."""
    coll = fake_world["c10d"]
    assert coll == {"all-reduce": 128, "all-gather": 512, "reduce-scatter": 32,
                    "all-to-all": 0, "collective-permute": 0, "count": 3}
    rec = fake_world["analyze"]
    from repro.launch.roofline import Roofline as JRoofline

    assert list(rec) == [f.name for f in dataclasses.fields(JRoofline)]
    assert rec["coll_bytes"] == 672 and rec["dominant"] == "collective"
    assert rec["collective_s"] == 672 / roofline.LINK_BW and rec["useful_ratio"] is None


def _reference_record_keys(ref):
    """The keys of the reference's ok record and of its roofline block, read
    from ``run_cell``'s source."""
    tree = ast.parse(inspect.getsource(ref.run_cell).lstrip())
    rec, roof = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "rec" and isinstance(node.value, ast.Dict):
            rec |= {k.value for k in node.value.keys}
        elif isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name) \
                and target.value.id == "rec":
            key = target.slice.value
            rec.add(key)
            if key == "roofline":
                roof |= {k.value for k in node.value.keys}
    return rec, roof


CELLS = [f"{arch} {kind}" for arch, _, kind in RECORD_CELLS]


@pytest.mark.parametrize("case", CELLS)
def test_record_has_the_reference_keys(ref, fake_world, case):
    """An ok record with the reference's keys, whose roofline terms are the
    full trace's count (the kernel path's bytes apart)."""
    rec = fake_world["records"][case]
    keys, roof = _reference_record_keys(ref)
    assert rec["status"] == "ok"
    assert set(rec) == keys
    assert set(rec["roofline"]) == roof and len(roof) == 14
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "generated_code_size_in_bytes",
                                  "alias_size_in_bytes", "total_hbm_bytes"}
    full, roofline = rec["full_module_cost"], rec["roofline"]
    assert full["flops"] > 0 and full["coll"] > 0
    assert (roofline["flops"], roofline["bytes_accessed"], roofline["coll_bytes"],
            roofline["transcendentals"]) == (full["flops"], full["bytes"], full["coll"],
                                             full["transcendentals"])
    kernel = roofline["bytes_accessed_kernel"]
    assert kernel == full["bytes"] if case.endswith("decode") else 0 < kernel != full["bytes"]
    assert 0 < rec["memory"]["total_hbm_bytes"] <= dryrun.HBM_BUDGET


@pytest.mark.parametrize("case", CELLS)
def test_report_row_equals_reference(fake_world, case):
    rec = fake_world["records"][case]
    skipped = {"arch": "a", "shape": "s", "status": "skipped", "reason": "r"}
    error = {"arch": "a", "shape": "s", "status": "error", "error": "E" * 50}
    for r in (rec, skipped, error):
        assert report.fmt_row(r) == jreport.fmt_row(r)
    assert report.HDR == jreport.HDR


def test_a_real_world_is_refused(fake_world):
    assert fake_world["refused"] and "fake world" in fake_world["refused"]
