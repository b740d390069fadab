"""The dry run's per-device op analysis (``repro_torch.launch.op_analysis``,
the counterpart of ``tests/test_hlo_analysis.py``): products counted
exactly, loops by their trip count (eager loops dispatch every iteration),
views moving nothing, a scatter into a large buffer counting only the
slice it moves, and per-device FLOPs and collectives on a fake 4 x 4 mesh.

Everything runs under ``FakeTensorMode``: no memory is allocated.
"""
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA


@pytest.fixture(scope="module")
def mesh():
    """A fake 4 x 4 data x model mesh, its group destroyed afterwards so
    that no other test module sees it."""
    from torch.distributed.device_mesh import DeviceMesh
    D.init_fake_group(16)
    yield DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _run(fn, *args):
    with FakeTensorMode() as fm:
        args = [fm.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        _, oa = OA.analyze(fn, *args)
    return oa.result(), oa


def test_single_matmul_flops():
    res, _ = _run(lambda a, b: a @ b, torch.empty(256, 512),
                  torch.empty(512, 128))
    assert res["flops"] == 2 * 256 * 512 * 128
    assert res["n_dots"] == 1


def test_loop_counts_every_iteration():
    """The reference recovers a scan's trip count; an eager loop
    dispatches its body each time."""
    def f(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x
    res, _ = _run(f, torch.empty(128, 128), torch.empty(12, 128, 128))
    assert res["flops"] == 12 * 2 * 128 ** 3
    assert res["n_dots"] == 12


def test_nested_loops():
    def f(x, ws):
        for i in range(ws.shape[0]):
            for _ in range(5):
                x = x @ ws[i]
        return x
    res, _ = _run(f, torch.empty(64, 64), torch.empty(3, 64, 64))
    assert res["flops"] == 15 * 2 * 64 ** 3


def test_view_moves_nothing():
    res, oa = _run(lambda a: a.view(64, 16).t()[:8], torch.empty(1024))
    assert res["bytes"] == 0 and oa.peak == 0


def test_elementwise_reads_and_writes():
    res, oa = _run(lambda a: a * 2.0, torch.empty(1024, 1024))
    assert res["bytes"] == 2 * 4 * 1024 * 1024
    assert oa.peak == 4 * 1024 * 1024


def test_index_copy_counts_the_slice():
    """A 4-row write into a 64 MB buffer moves the rows and indices, not
    the buffer (the reference's dynamic-update-slice / scatter rule)."""
    res, oa = _run(lambda buf, idx, src: buf.index_copy_(0, idx, src),
                   torch.empty(65536, 256), torch.arange(4),
                   torch.empty(4, 256))
    assert res["bytes"] == 4 * 8 + 4 * 256 * 4
    assert oa.peak == 0


def test_kernel_call_counts_its_call_site():
    """A kernel's plain version counts its products, and only its operands
    and output as bytes and memory (the kernel keeps its scores on
    chip)."""
    B, S, H, D = 2, 64, 4, 32
    q = torch.empty(B, S, H, D)
    pos = torch.zeros(B, S, dtype=torch.int32)

    def f(q, pos):
        return ops.flash_attention(q, q, q, pos, pos, window=None,
                                   scale=0.1)
    res, oa = _run(f, q, pos)
    assert res["flops"] == 2 * (2 * B * H * S * S * D)
    qb, pb = q.numel() * 4, pos.numel() * 4
    assert res["bytes"] == 4 * qb + 2 * pb
    assert res["bytes_by_op"] == {"kernel:flash_attention": 4 * qb + 2 * pb}
    assert oa.peak == qb


def test_row_parallel_pair_per_device(mesh):
    """x (B over data) @ w1 (columns over model) @ w2 (rows over model):
    1/16 of the global FLOPs on each device and one all-reduce of the
    device's output."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 128), mesh,
                              [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.empty(128, 256), mesh,
                               [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.empty(256, 128), mesh,
                               [Replicate(), Shard(0)])

        def f(x, w1, w2):
            return ((x @ w1) @ w2).redistribute(mesh,
                                                [Shard(0), Replicate()])
        out, oa = OA.analyze(f, x, w1, w2)
    res = oa.result()
    glob = 2 * 64 * 128 * 256 + 2 * 64 * 256 * 128
    assert res["flops"] == glob / 16
    assert res["collectives"]["counts"] == {
        "all_gather": 0, "all_reduce": 1, "reduce_scatter": 0,
        "all_to_all": 0}
    assert res["collectives"]["total_bytes"] == 16 * 128 * 4
    assert oa.argument_bytes == (16 * 128 + 128 * 64 + 64 * 128) * 4


def test_kernel_gradient_is_one_op():
    """Under autograd the plain version's graph stays uncounted: the
    backward is one ``_bwd`` op whose bytes are its call site's, and no
    (B, H, S, S) score tensor is ever live."""
    B, S, H, D = 2, 256, 4, 32
    pos = torch.zeros(B, S, dtype=torch.int32)

    def f(q, pos):
        q = q.requires_grad_()
        out = ops.flash_attention(q, q, q, pos, pos, window=None, scale=0.1)
        (g,) = torch.autograd.grad(out.sum(), q)
        return g
    res, oa = _run(f, torch.empty(B, S, H, D), pos)
    assert set(res["bytes_by_op"]) >= {"kernel:flash_attention",
                                       "kernel:flash_attention_bwd"}
    qb = B * S * H * D * 4
    assert oa.peak <= 6 * qb < B * H * S * S * 4
    assert res["flops"] >= 3 * 2 * (2 * B * H * S * S * D)
