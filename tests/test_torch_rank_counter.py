"""``analysis.rank.RankCounter`` on programs whose per-rank counts are
worked out by hand, on a fake world of 256 ranks, mesh (16, 16) over
(data, model), with meta tensors (nothing allocated).

The product (4096 × 1024) @ (1024 × 2048), rows over ``data`` and
columns over ``model``: a rank multiplies (256 × 1024) @ (1024 × 128),
2·256·1024·128 = 6.71e7 FLOPs, where ``FlopCounterMode`` counts the
global 1.718e10.  Its bytes: the two local operands and the local output,
1,048,576 + 524,288 + 131,072 B.  Gathering the (4096 × 2048) f32 result
whole: an all-gather over ``data`` of the rank's 131,072 B (15 parts of
it on the wire) and one over ``model`` of the 2,097,152 B column block
(15 parts).  An all-reduce of n B over 16 ranks moves 2·15/16·n, a
reduce-scatter 15/16·n.
"""

import pytest
import torch

from repro_torch.analysis.rank import RankCounter

N, K, M = 4096, 1024, 2048


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _dt(mesh, shape, placements):
    from torch.distributed.tensor import DTensor

    from repro_torch.models.parallel import cut

    local, _ = cut(shape, mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _operands(mesh):
    from torch.distributed.tensor import Replicate, Shard

    return (_dt(mesh, (N, K), [Shard(0), Replicate()]),
            _dt(mesh, (K, M), [Replicate(), Shard(1)]))


def test_product_counts_the_ranks_shards(mesh):
    from torch.utils.flop_counter import FlopCounterMode

    a, b = _operands(mesh)
    c = RankCounter()
    c.track((a, b))
    with c:
        y = a @ b
    assert c.flops == 2 * 256 * K * 128 == 67108864
    assert c.bytes == (256 * K + K * 128 + 256 * 128) * 4
    assert c.peak_bytes == c.bytes
    assert c.collectives == {}
    assert tuple(y._local_tensor.shape) == (256, 128)
    with FlopCounterMode(display=False) as glob:
        a @ b
    assert glob.get_total_flops() == 2 * N * K * M == 17179869184


def test_gathering_the_product_counts_its_all_gathers(mesh):
    from torch.distributed.tensor import Replicate

    a, b = _operands(mesh)
    c = RankCounter()
    with c:
        y = (a @ b).redistribute(mesh, [Replicate(), Replicate()])
    ag = c.collectives["all_gather_into_tensor"]
    assert ag["count"] == 2
    assert ag["bytes"] == 15 * 256 * 128 * 4 + 15 * N * 128 * 4
    assert c.wire_bytes == ag["bytes"]
    assert tuple(y._local_tensor.shape) == (N, M)
    # the whole result (33.5 MB) is alive at the end, on top of the
    # column block it was gathered from
    assert c.peak_bytes >= N * M * 4 + N * 128 * 4


def test_all_reduce_and_reduce_scatter_wire_bytes(mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard

    n = 1024 * 4
    c = RankCounter()
    with c:
        p = _dt(mesh, (1024,), [Partial(), Replicate()])
        p.redistribute(mesh, [Replicate(), Replicate()])
        q = _dt(mesh, (1024,), [Partial(), Replicate()])
        q.redistribute(mesh, [Shard(0), Replicate()])
    assert c.collectives["all_reduce"]["bytes"] == 2 * 15 / 16 * n
    assert c.collectives["reduce_scatter_tensor"]["bytes"] == 15 / 16 * n


def test_pointwise_and_reduction_flops_and_freed_storage(mesh):
    from torch.distributed.tensor import Replicate, Shard

    x = _dt(mesh, (N, K), [Shard(0), Replicate()])
    c = RankCounter()
    c.track(x)
    with c:
        t = x * 2.0                         # 256·1024 outputs
        s = t.sum(dim=1)                    # 256·1024 inputs summed
        del t
        u = x + 1.0                         # reuses the freed room
    local = 256 * K
    assert c.flops == 3 * local
    assert c.peak_bytes == 2 * local * 4 + 256 * 4
    assert c.live_bytes == 2 * local * 4 + 256 * 4
    del s, u
