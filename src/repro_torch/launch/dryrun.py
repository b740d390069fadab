"""Multi-pod dry run: trace one step of every (arch x input shape x mesh)
on a fake mesh and record its per-device memory, FLOPs, bytes and
collectives (the port's counterpart of ``repro.launch.dryrun``).

The reference forces 512 placeholder host devices and lowers and compiles
each jitted step.  Here one process initialises ``torch.distributed``'s
``fake`` backend with as many ranks as the production mesh has
(:func:`init_fake_group`), builds the mesh over it, draws the target's
arguments as fake tensors (``FakeTensorMode``: no memory is allocated)
distributed by the sharding rules, and runs the step once under
:class:`~repro_torch.launch.op_analysis.OpAnalysis`.  The fake tensors
are CPU tensors: every kernel takes its plain version, which the analysis
counts as one op, as the reference's dry run lowers its jnp path.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k              # -> build/dryrun/<tag>.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch import perf_flags
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch.op_analysis import OpAnalysis, _locals
from repro_torch.launch.specs import INPUT_SHAPES, make_target
from repro_torch.sharding import partition as SH

OUT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")


def init_fake_group(world_size: int) -> None:
    """The default process group as ``world_size`` fake ranks in this
    process (this process is rank 0; collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def _bytes(tree) -> int:
    seen = {}
    for t in _locals(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def run_one(arch: str, shape: str, multi_pod: bool = False, *, cfg=None,
            mesh=None, info=None, make=None) -> dict:
    """Trace one combo and return its record.  ``cfg`` / ``mesh`` /
    ``info`` replace the arch's config, the production mesh (and its fake
    group) and the input shape's entry (tests shrink all three);
    ``make(cfg, mesh)`` replaces ``specs.make_target`` (a target with
    other switches)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    if mesh is None:
        init_fake_group(512 if multi_pod else 256)
        mesh = M.make_production_mesh(multi_pod=multi_pod)
    SH.set_current_mesh(mesh)              # enables in-model constraints
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(map(str, mesh.shape)), "chips": mesh.size()}
    t0 = time.perf_counter()
    with FakeTensorMode():
        target = (make(cfg, mesh) if make is not None
                  else make_target(cfg, shape, mesh, info=info))
        t1 = time.perf_counter()
        with OpAnalysis(target.args) as oa:
            out = target.fn(*target.args)
        t2 = time.perf_counter()
    rec.update(target.static_meta)
    rec["build_s"] = round(t1 - t0, 2)
    rec["trace_s"] = round(t2 - t1, 2)

    # -- memory (per device) --------------------------------------------------
    out_b = oa.output_bytes(out)
    args = target.args
    kind = target.static_meta["kind"]
    rec["memory"] = {
        "argument_size_in_bytes": oa.argument_bytes,
        "output_size_in_bytes": out_b,
        "temp_size_in_bytes": oa.peak - out_b,
        "peak_memory_in_bytes": oa.argument_bytes + oa.peak,
        "parameter_bytes": _bytes(args[0]),
        "optimizer_bytes": (_bytes((args[1].mu, args[1].nu))
                            if kind == "train" else 0),
        "cache_bytes": (_bytes(args[3] if kind == "prefill" else args[2])
                        if kind != "train" else 0),
    }

    # -- per-device flops / bytes / collectives ------------------------------
    ha = oa.result()
    rec["hlo"] = {k: ha[k] for k in ("flops", "bytes", "n_dots",
                                     "bytes_by_op")}
    rec["collectives"] = ha["collectives"]

    # -- model flops (roofline 'useful compute') ----------------------------
    pc = cfg.param_counts()
    info = info or INPUT_SHAPES[shape]
    tokens = info["batch"] * (1 if info["kind"] == "decode"
                              else info["seq"])
    mult = 6 if info["kind"] == "train" else 2
    rec["model_flops"] = {
        "params_total": pc["total"], "params_active": pc["active"],
        "tokens": tokens,
        "flops": mult * (pc["active"] - pc["embed"]) * tokens,
    }
    rec["perf_opts"] = perf_flags.active()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every combo in subprocesses")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--suffix", default=None,
                    help="artifact tag suffix for perf-flag variants")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        failures = []
        combos = [(a, s, mp) for a in ASSIGNED for s in INPUT_SHAPES
                  for mp in ((False, True) if args.both_meshes
                             else (False,))]
        for i, (a, s, mp) in enumerate(combos):
            tag = f"{a}__{s}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[{i+1}/{len(combos)}] {tag}: cached", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--out", args.out]
            if mp:
                cmd.append("--multi-pod")
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True)
            ok = r.returncode == 0
            print(f"[{i+1}/{len(combos)}] {tag}: "
                  f"{'ok' if ok else 'FAIL'} ({time.time()-t0:.0f}s)",
                  flush=True)
            if not ok:
                failures.append(tag)
                with open(os.path.join(args.out, tag + ".err"), "w") as f:
                    f.write(r.stdout[-4000:] + "\n" + r.stderr[-8000:])
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all)")
    rec = run_one(args.arch, args.shape, args.multi_pod)
    tag = (f"{args.arch}__{args.shape}__"
           f"{'2x16x16' if args.multi_pod else '16x16'}")
    if args.suffix:
        tag += f"__{args.suffix}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "mesh", "build_s", "trace_s")}))
    print("memory:", rec["memory"])
    print("hlo:", rec["hlo"])
    print("collectives:", rec["collectives"]["total_bytes"],
          rec["collectives"]["counts"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
