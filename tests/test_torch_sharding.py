"""The port's sharding rules (``repro_torch.sharding.partition``) against
the reference's (``repro.sharding.partition``), leaf by leaf, and a
sharded forward on real values across four gloo ranks.

The reference's specs come from ``jax.eval_shape`` of its
``init_params`` / ``cache_struct`` trees, the port's from its own trees
made under ``FakeTensorMode`` (nothing is allocated, full width too);
``bridge.pspecs_from_jax`` maps each stacked reference spec onto the
port's per-layer leaf (its leading repeats entry dropped).  Specs compare
exactly, padded with None to the leaf's rank.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as JR
from repro.models import transformer as JT
from repro.sharding import partition as JSH
from repro.training import optimizer as JOPT
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as SH
from repro_torch.training import optimizer as OPT

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = R.list_archs()
FULL = ["qwen3-4b", "qwen3-moe-235b-a22b", "deepseek-v3-671b"]


def _jax_mesh(shape=(16, 16), names=("data", "model")):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(shape, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, shape)))


MESH = SH.AbstractMesh((16, 16), ("data", "model"))
POD_MESH = SH.AbstractMesh((2, 16, 16), ("pod", "data", "model"))


@functools.lru_cache(maxsize=None)
def _trees(arch: str, full: bool):
    """(reference struct, port fake params, both configs) of an arch."""
    get = JR.get_config if full else JR.get_reduced
    jcfg = get(arch)
    struct = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    cfg = (R.get_config if full else R.get_reduced)(arch)
    with FakeTensorMode():
        params = T.init_params(torch.Generator().manual_seed(0), cfg)
    return struct, params, jcfg, cfg


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _assert_specs_equal(port, ref, tree):
    """Every leaf of ``tree`` (flattened paths) has equal specs."""
    ps, rs = SH.flat_specs(port), SH.flat_specs(ref)
    ts = OPT.flatten(tree)
    assert set(ps) == set(rs) == set(ts)
    for path, t in ts.items():
        assert _pad(ps[path], t.ndim) == _pad(rs[path], t.ndim), \
            (path, ps[path], rs[path])


def _param_case(arch, full, fsdp):
    struct, params, jcfg, cfg = _trees(arch, full)
    ref = bridge.pspecs_from_jax(JSH.param_pspecs(struct, jcfg, fsdp=fsdp),
                                 cfg)
    _assert_specs_equal(SH.param_pspecs(params, cfg, fsdp=fsdp), ref,
                        params)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_reduced(arch, fsdp):
    _param_case(arch, False, fsdp)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", FULL)
def test_param_pspecs_full_width(arch, fsdp):
    _param_case(arch, True, fsdp)


def test_tp_attn_guard_replicates_internvl2(monkeypatch):
    """14 heads on a 16-way model axis: attention weights replicated, in
    both packages, and only under the flag."""
    struct, params, _, cfg = _trees("internvl2-1b", False)
    full = JR.get_config("internvl2-1b")        # 14 % 16 != 0
    for flag in ("tp_attn_guard", ""):
        monkeypatch.setenv("REPRO_PERF_OPTS", flag)
        ref = bridge.pspecs_from_jax(JSH.param_pspecs(
            struct, full, fsdp=False, mesh=_jax_mesh()), cfg)
        port = SH.param_pspecs(params, R.get_config("internvl2-1b"),
                               fsdp=False, mesh=MESH)
        _assert_specs_equal(port, ref, params)
        wq = port["layers"][0]["attn"]["wq"]
        assert (tuple(wq) == (None, None)) == (flag == "tp_attn_guard")


def test_sanitize_spec():
    assert tuple(SH.sanitize_spec(SH.P("model", None), (32001, 16),
                                  MESH)) == (None, None)
    assert tuple(SH.sanitize_spec(SH.P("model", "data"), (32000, 160),
                                  MESH)) == ("model", "data")
    jm = _jax_mesh()
    for spec, shape in ((("model", None), (32001, 16)),
                        ((("data", "model"), None), (512, 3)),
                        ((("data", "model"), None), (500, 3))):
        assert tuple(SH.sanitize_spec(SH.P(*spec), shape, MESH)) == \
            tuple(JSH.sanitize_spec(JP(*spec), shape, jm))


@pytest.mark.parametrize("batch", [256, 128, 32, 1])
def test_batch_pspec(batch):
    for mesh, jshape in ((MESH, ((16, 16), ("data", "model"))),
                         (POD_MESH, ((2, 16, 16), ("pod", "data",
                                                   "model")))):
        for extra in (1, 2):
            assert tuple(SH.batch_pspec(mesh, batch, extra)) == tuple(
                JSH.batch_pspec(_jax_mesh(*jshape), batch, extra))


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b",
                                  "xlstm-125m", "hymba-1.5b"])
@pytest.mark.parametrize("batch,max_len", [(128, 512), (1, 2048)],
                         ids=["batch_sharded", "long_500k_style"])
def test_cache_pspecs(arch, batch, max_len):
    """A batch-sharded decode cache and a single-stream one whose KV
    sequence shards over (data, model)."""
    jcfg, cfg = JR.get_reduced(arch), R.get_reduced(arch)
    jm = _jax_mesh()
    ref = JSH.cache_pspecs(JT.cache_struct(jcfg, batch, max_len), jm, batch)
    with FakeTensorMode():
        cache = T.init_cache(cfg, batch, max_len)
    _assert_specs_equal(SH.cache_pspecs(cache, MESH, batch),
                        bridge.cache_pspecs_from_jax(ref, cfg), cache)


def test_factored_nu_pspecs_qwen3_4b():
    """The factored state's statistic specs, keyed as the port's state is:
    per-layer statistics drop the repeats entry, a 1-D layer leaf's shared
    pair keeps the reference's spec of the stacked leaf."""
    struct, params, jcfg, cfg = _trees("qwen3-4b", False)
    jspecs = JSH.param_pspecs(struct, jcfg, fsdp=True)
    ref_nu = JOPT.factored_nu_pspecs(jspecs, struct)
    groups = OPT.layer_groups(cfg)
    want = {}
    leaves = list(bridge._jax_order(struct))
    assert len(leaves) == len(ref_nu)
    for (path, leaf), sp in zip(leaves, ref_nu):
        conv = functools.partial(bridge._map, lambda s: SH.P(*tuple(s)))
        if path[0] != "stacks":
            want["/".join(map(str, path))] = conv(sp)
            continue
        si, pi, rest = path[1], path[2], "/".join(map(str, path[3:]))
        if len(leaf.shape) == 2:
            want[f"stacks/{si}/{pi}/{rest}"] = conv(sp)
            continue
        for l in groups[si, pi]:
            want[f"layers/{l}/{rest}"] = bridge._map(
                lambda s: SH.P(*tuple(s)[1:]), sp)
    got = OPT.factored_nu_pspecs(
        SH.param_pspecs(params, cfg, fsdp=True), params, cfg)
    state = OPT.init_state(params, factored=True, model_cfg=cfg)
    assert set(got) == set(want) == set(state.nu)
    for key, spec in got.items():
        st = state.nu[key]
        if isinstance(st, dict):
            for part in ("r", "c"):
                assert _pad(spec[part], st[part].ndim) == \
                    _pad(want[key][part], st[part].ndim), (key, part)
        else:
            assert _pad(spec, st.ndim) == _pad(want[key], st.ndim), key


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_shard_local_cache_writes(kind):
    """A dense cache whose sequence dim is split in four shards, each
    written on its own (``kv_cache``'s ``shard`` = (rows, first row), what
    ``sharding.spmd.write_cache`` passes), equals the whole cache's write:
    resumed rows, padding (the dump slot, whose K/V is unspecified) and
    decode steps landing in different shards."""
    from repro_torch.core import kv_cache as KV
    cfg = R.get_reduced("qwen3-4b")
    gen = torch.Generator().manual_seed(0)
    B, S = 3, 40
    cache = T.init_cache(cfg, B, 300, torch.float32)["layers"][0]
    rows = cache["pos"].shape[1]
    H, D = cache["k"].shape[2:]
    new = {"k": torch.randn(B, S if kind == "prefill" else 1, H, D,
                            generator=gen)}
    new["v"] = torch.randn(new["k"].shape, generator=gen)
    if kind == "prefill":
        index = torch.stack([torch.arange(S), torch.arange(S),
                             torch.arange(S) + 100]).to(torch.int32)
        index[1, 30:] = -1
        write = KV.write_prefill
    else:
        index = torch.tensor([39, 300, 128], dtype=torch.int32)
        write = KV.write_decode
    want = write({k: v.clone() for k, v in cache.items()}, new, index)
    n = rows // 4
    got = []
    for c in range(4):
        part = {k: v[:, c * n:(c + 1) * n].clone() for k, v in cache.items()}
        got.append(write(part, new, index, shard=(rows, c * n)))
    for key in ("k", "v", "pos"):
        whole = torch.cat([g[key] for g in got], dim=1)
        keep = slice(None) if key == "pos" else slice(0, rows - 1)
        assert torch.equal(whole[:, keep], want[key][:, keep]), key


# ---------------------------------------------------------------------------
# Real values on a 2 x 2 gloo mesh
# ---------------------------------------------------------------------------

_GLOO_RANK = textwrap.dedent(r"""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.precision import FP32
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partition as SH

    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method=sys.argv[2], rank=rank,
                            world_size=4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    SH.set_current_mesh(mesh)
    out = {}
    for arch in ("qwen3-4b", "qwen3-moe-235b-a22b"):
        cfg = get_reduced(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg)
        tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                               generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            want, _ = T.forward_train(params, cfg, tokens, policy=FP32,
                                      remat=False)
        dp = SH.with_sharding(params, SH.param_pspecs(params, cfg), mesh)
        dt = SH.with_sharding({"t": tokens},
                              {"t": SH.batch_pspec(mesh, 4)}, mesh)["t"]
        for flag in ("", "seq_parallel"):
            os.environ["REPRO_PERF_OPTS"] = flag
            with torch.no_grad(), implicit_replication():
                got, _ = T.forward_train(dp, cfg, dt, policy=FP32,
                                         remat=False)
            out[f"{arch}|{flag}"] = [
                float((got.full_tensor() - want).abs().max()),
                [str(p) for p in got.placements]]
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def test_gloo_sharded_forward_train_matches_single_process():
    """Reduced qwen3-4b (GQA) and qwen3-moe (experts over model) at fp32:
    forward_train with the parameters distributed by the rules on a 2 x 2
    data x model mesh of four gloo ranks gives the single-process logits
    within 1e-5, with seq_parallel off and on."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_RANK, str(r),
         f"tcp://localhost:{port}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert len(res) == 4
    for key, (err, placements) in res.items():
        assert err < 1e-5, (key, err)
