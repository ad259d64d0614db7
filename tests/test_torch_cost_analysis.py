"""`launch.cost_analysis` — the dry-run's counter on meta tensors — held
to the cases `tests/test_launch.py` holds the reference's HLO parser to:
a matmul counts 2·m·k·n, a loop of 12 counts 12 times, nested loops of
5 × 3 count 15 times, views add no bytes, an all-reduce counts twice its
result bytes; and a kernel's meta branch reports its formula's work and
launches nothing (the gradient's, each launch's share)."""
import pytest
import torch

from repro_torch.distributed.comm import AxesView, ShapeMesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, work
from repro_torch.launch import cost_analysis as ca

torch.set_num_threads(1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (7, 5, 3), (1, 128, 1)])
def test_matmul_counts_2mkn(m, k, n):
    cost = ca.full_cost(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert cost["flops"] == 2 * m * k * n
    assert cost["bytes"] == 4 * (m * k + k * n + m * n)
    assert cost["result"].shape == (m, n)


def test_loop_counts_every_trip():
    def body(x, w):
        for _ in range(12):
            x = x @ w
        return x

    cost = ca.full_cost(body, _meta(8, 16), _meta(16, 16))
    assert cost["flops"] == 12 * 2 * 8 * 16 * 16


def test_nested_loops_multiply():
    def body(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    cost = ca.full_cost(body, _meta(4, 8), _meta(8, 8))
    assert cost["flops"] == 15 * 2 * 4 * 8 * 8


def test_views_add_no_bytes():
    x = _meta(16, 32)
    views = ca.full_cost(lambda t: t.view(32, 16).transpose(0, 1)[:4]
                         [None].expand(3, 4, 32).permute(2, 0, 1), x)
    assert views["bytes"] == 0 and views["flops"] == 0
    copy = ca.full_cost(lambda t: t.transpose(0, 1).contiguous(), x)
    assert copy["bytes"] == 2 * 16 * 32 * 4


def test_all_reduce_counts_twice_its_result():
    mesh = ShapeMesh((2, 4), ("data", "model"), rank=5)
    x = _meta(10, 3)

    def body(t):
        return mesh.all_gather(mesh.psum(t, "model"), "data")

    cost = ca.full_cost(body, x, mesh=mesh)
    col = cost["collective"]
    assert col["by_kind"]["all-reduce"] == 2 * 120
    assert col["by_kind"]["all-gather"] == 240
    assert col["op_counts"] == {"all-reduce": 1, "all-gather": 1}
    assert col["per_device_bytes"] == 2 * 120 + 240
    assert col["by_axis"] == {"data": {"calls": 1, "bytes": 120},
                              "model": {"calls": 1, "bytes": 120}}
    assert cost["result"].shape == (20, 3)
    # The rank's position and a view along one axis.
    assert mesh.axis_index("data") == 1 and mesh.axis_index("model") == 1
    view = AxesView(mesh, ("data",))
    assert view.rank == 1 and view.shape == {"data": 2}


def test_peak_and_argument_bytes():
    def body(a):
        b = a * 2                       # 4 KiB live beside a
        c = b + 1                       # and 4 more
        del b
        return c.sum()

    cost = ca.full_cost(body, _meta(1024))
    assert cost["argument_bytes"] == 4096
    assert cost["peak_bytes"] == 3 * 4096


def test_kernel_meta_branch_reports_its_work():
    b, lq, lk, h, kvh, d = 2, 1, 300, 8, 2, 64
    q = _meta(b, lq, h, d, dtype=torch.bfloat16)
    k = _meta(b, lk, kvh, d, dtype=torch.bfloat16)
    ops.reset_launches()
    cost = ca.full_cost(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True, kv_offset=99, return_lse=True), q, k, k)
    assert sum(ops.LAUNCHES.values()) == 0
    out, lse = cost["result"]
    assert out.shape == q.shape and lse.shape == (b, h, 1)
    # Only the 100 visible keys are read and attended.
    want = work.flash_forward(q, k, True, 99, True)
    assert want[0] == 4 * b * h * 100 * d
    assert cost["kernels"] == {"flash_decode": {
        "calls": 1, "flops": want[0], "bytes": want[1]}}
    assert cost["flops"] == want[0]
    # No key visible: no launch, no work.
    cost = ca.full_cost(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True, kv_offset=-1, return_lse=True), q, k, k)
    assert cost["kernels"] == {}
    # The coverage kernel, and mixed devices still raise.
    vis = _meta(3, 50, 2, dtype=torch.int32)
    cost = ca.full_cost(lambda v, a: ops.cover_counts(v, a), vis,
                        _meta(3, 2, dtype=torch.int32))
    assert cost["kernels"]["cover_counts"]["flops"] == 3 * 3 * 50 * 2
    assert cost["result"].shape == (50,)
    with pytest.raises(ValueError, match="mixed"):
        ops.cover_counts(vis, torch.zeros((3, 2), dtype=torch.int32))
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("d,dtype,launches", [
    (128, torch.bfloat16, 2), (128, torch.float32, 2),
    (192, torch.bfloat16, 3), (192, torch.float32, 3),
    (32, torch.float32, 2)])
def test_backward_meta_branch_reports_each_launch(d, dtype, launches):
    """The gradient's meta branch reports one call a launch of its route
    (wgmma in bf16, tf32x3 in float32, simt at D 32; three at D 192 on
    every route: dq, dv, dk), whose work sums to the
    whole gradient's (10·D a visible pair; q, o, do, dq, k, v, dk and dv
    once), the dq launch's 6·D with every input, and at D 192 dv's and
    dk's 2·D each with its own output."""
    b, L, h, kvh = 2, 40, 12, 2
    q, do = (_meta(b, L, h, d, dtype=dtype) for _ in range(2))
    k, v = (_meta(b, L, kvh, d, dtype=dtype) for _ in range(2))
    route = fa.route_bwd(dtype, L, d)
    lse = _meta(b, h, L) if route in fa.LSE_BWD_ROUTES else None
    ops.reset_launches()
    cost = ca.full_cost(lambda *t: ops.flash_attention_bwd(
        *t, causal=True, lse=lse), q, k, v, q, do)
    assert sum(ops.LAUNCHES.values()) == 0
    assert [t.shape for t in cost["result"]] == [q.shape, k.shape, v.shape]
    pairs = b * h * L * (L + 1) // 2
    e = q.element_size()
    total = work.flash_backward(q, k, True)
    assert total == (10 * pairs * d,
                     e * (4 * b * L * h * d + 4 * b * L * kvh * d))
    assert cost["kernels"] == {f"flash_bwd_{route}": {
        "calls": launches, "flops": total[0], "bytes": total[1]}}
    parts = work.flash_backward_launches(q, k, True)
    assert len(parts) == launches == fa.bwd_launches(dtype, L, d)
    assert parts[0][0] == 6 * pairs * d
    if launches == 3:
        assert parts[1] == parts[2] == (2 * pairs * d, e * b * L * kvh * d)


@pytest.mark.parametrize("d", [128, 192])
def test_float32_training_forward_meta_reports_the_tf32x3_route(d):
    """A float32 training forward at D 128 and 192 reports one
    ``flash_tf32x3`` call of 4·D operations a visible pair whose bytes
    include the lse it writes, and returns that (B, H, L) lse for its
    backward, which reports its launches as ``flash_bwd_tf32x3``."""
    b, L, h, kvh = 1, 48, 12, 2
    q, do = (_meta(b, L, h, d) for _ in range(2))
    k, v = (_meta(b, L, kvh, d) for _ in range(2))
    assert fa.route(torch.float32, b, L, L, h, kvh, d, True) == "tf32x3"
    ops.reset_launches()
    cost = ca.full_cost(lambda *t: ops.flash_attention_fwd(*t, causal=True),
                        q, k, v)
    out, lse = cost["result"]
    assert out.shape == q.shape and lse.shape == (b, h, L)
    want = work.flash_forward(q, k, True, 0, True)
    assert want[1] == work.flash_forward(q, k, True, 0, False)[1] \
        + 4 * b * h * L
    assert cost["kernels"] == {"flash_tf32x3": {
        "calls": 1, "flops": want[0], "bytes": want[1]}}
    bwd = ca.full_cost(lambda *t: ops.flash_attention_bwd(
        *t, causal=True, lse=lse), q, k, v, q, do)
    assert set(bwd["kernels"]) == {"flash_bwd_tf32x3"}
    assert bwd["kernels"]["flash_bwd_tf32x3"]["calls"] \
        == fa.bwd_launches(torch.float32, L, d)
    assert sum(ops.LAUNCHES.values()) == 0
