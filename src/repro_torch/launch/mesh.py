"""Production and host meshes (the port's counterpart of
``repro.launch.mesh``): ``torch.distributed`` DeviceMeshes over the
process group the caller initialised.

The dry run (:mod:`repro_torch.launch.dryrun`) initialises the ``fake``
backend with 256 or 512 ranks in one process, the counterpart of the
reference forcing 512 placeholder host devices; :func:`make_host_mesh`
builds a mesh over the real local devices.  Defined as functions (never
module-level constants), so importing this module touches no device or
process group.
"""
from __future__ import annotations

import torch

SINGLE_POD = (16, 16)                  # 256 chips
MULTI_POD = (2, 16, 16)                # 2 pods x 256 chips

# roofline constants of one NVIDIA H100 80GB HBM3 (SXM5, 700 W), from
# NVIDIA's spec sheet: dense bf16 tensor-core peak, HBM3 bandwidth, and
# NVLink 4 per direction a GPU
PEAK_FLOPS_BF16 = 989e12               # FLOP/s
HBM_BW = 3.35e12                       # B/s
NVLINK_BW = 450e9                      # B/s


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """The (16, 16) ``data`` x ``model`` mesh, or (2, 16, 16) with
    ``pod`` in front, over the default process group, which must hold at
    least that many ranks (the dry run's fake group has exactly that
    many)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}; the dry run initialises the "
            f"'fake' process group with {n} ranks first "
            f"(dryrun.init_fake_group)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device: str = "cuda"):
    """A ``data`` x ``model`` mesh over the local devices: on one card a
    (1, 1) mesh over ``cuda`` from an ``nccl`` group of world size 1 on a
    local ``HashStore`` (no network).  Raises without CUDA unless the
    caller asks for ``device="cpu"`` (a ``gloo`` group), as the tests do.
    Reuses a default group the caller initialised (one rank a device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA "
                           "device; pass device='cpu' for a CPU mesh")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    data = n // model_axis
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device, torch.arange(data * model_axis).reshape(
        data, model_axis), mesh_dim_names=("data", "model"))
