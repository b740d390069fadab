"""The port's dry run (``repro_torch.launch.dryrun``) on a small fake mesh:
the reference's ``test_dryrun_small_mesh_all_families`` (three families
at its shrunken train_4k and decode_32k on a 4 x 4 mesh), the config's
``param_counts()`` and the dry run's model FLOPs against the reference's,
and ``seq_parallel`` acting through the mesh.

The fake process group (16 ranks, this process rank 0) lives in a
module-scoped fixture and is destroyed afterwards, so that no other test
module sees it.
"""
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as JR
from repro_torch.configs import registry as R
from repro_torch.launch import dryrun as D

SHAPES = {"train_4k": {"kind": "train", "seq": 64, "batch": 8},
          "decode_32k": {"kind": "decode", "seq": 512, "batch": 8}}
FAMILIES = ["qwen3-4b", "deepseek-v3-671b", "xlstm-125m"]


@pytest.fixture(scope="module")
def run():
    """run(arch, shape, perf_opts) -> the dry-run record, each combo traced
    once on a fake 4 x 4 data x model mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    D.init_fake_group(16)
    mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                      mesh_dim_names=("data", "model"))
    recs = {}
    mp = pytest.MonkeyPatch()

    def one(arch, shape, opts=""):
        if (arch, shape, opts) not in recs:
            mp.setenv("REPRO_PERF_OPTS", opts)
            recs[arch, shape, opts] = D.run_one(
                arch, shape, cfg=R.get_reduced(arch).replace(vocab_size=512),
                mesh=mesh, info=SHAPES[shape])
        return recs[arch, shape, opts]
    yield one
    mp.undo()
    D.SH.set_current_mesh(None)
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_small_mesh_all_families(run, arch, shape):
    rec = run(arch, shape)
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["bytes"] > 0
    assert rec["chips"] == 16 and rec["mesh"] == "4x4"
    mem = rec["memory"]
    assert 0 < mem["parameter_bytes"] <= mem["argument_size_in_bytes"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    if shape == "train_4k":
        # sharded graphs must actually communicate
        assert rec["collectives"]["total_bytes"] > 0
        assert mem["optimizer_bytes"] > 0
    else:
        assert mem["cache_bytes"] > 0


@pytest.mark.parametrize("arch", R.list_archs())
def test_param_counts_match_reference(arch):
    assert R.get_config(arch).param_counts() == \
        JR.get_config(arch).param_counts()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_reference_formula(run, shape):
    """The reference's dryrun.py:92-104 on its own config."""
    rec = run("qwen3-4b", shape)
    info = SHAPES[shape]
    pc = JR.get_reduced("qwen3-4b").replace(vocab_size=512).param_counts()
    tokens = info["batch"] * (info["seq"] if shape != "decode_32k" else 1)
    if info["kind"] == "decode":
        tokens = info["batch"]
    mult = 6 if info["kind"] == "train" else 2
    assert rec["model_flops"] == {
        "params_total": pc["total"], "params_active": pc["active"],
        "tokens": tokens, "flops": mult * (pc["active"] - pc["embed"])
        * tokens}


def test_seq_parallel_adds_collectives(run):
    """seq_parallel shards the embedded activations' sequence over
    ``model``: the train step then reduce-scatters / gathers activations
    it did not before."""
    base = run("qwen3-4b", "train_4k")["collectives"]
    sp = run("qwen3-4b", "train_4k", "seq_parallel")["collectives"]
    assert sp["total_bytes"] != base["total_bytes"]
    assert any(sp["counts"][c] > base["counts"][c] for c in base["counts"])
