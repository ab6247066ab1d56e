"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so it runs on the card alone (see
README, "PyTorch port"). K1 is held bit for bit to its summation order
run with plain ops on the CPU (on bf16 g, that order's fp32 sums rounded
once to bf16), and to fp64 within the fp32 summation bound;
K2's tolerances follow the fp32 summation bound: kernel and reference sum
each output in different orders. The CIN
kernels' checks are ``ops/cin_tolerances.py``'s (K3 and K4, forward and
backward, at the TPU kernels' bf16 contract, against their bf16
emulations and fp64), the attention kernels' ``ops/attention_tolerances.py``'s;
each module states them.
"""

import warnings

import numpy as np
import pytest
import torch

from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import attention_tolerances as at
from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct
from deep_recommenders_torch.ops import embedding_kernels as ek
from deep_recommenders_torch.ops import fm

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_kernel(device, skewed):
    """K1 at DeepFM's shape: one launch a call, equal bit for bit to its
    summation order run on the CPU and to itself over three calls, and
    within the fp32 summation bound of fp64 (~1500 fp32 adds into a hot row
    of size ~40: rtol 1e-5, atol 1e-3)."""
    rng = np.random.default_rng(0)
    n, c, v = 16384, 17, 10044
    ids = rng.integers(0, v, n).astype(np.int32)
    if skewed:
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    ids = torch.from_numpy(ids)
    want = ek.scatter_add_rows_in_segments(g, ids, v)
    exact = ek.scatter_add_rows_reference(g.double(), ids, v)
    before = ek.scatter_add_rows.launches
    runs = [ek.scatter_add_rows(g.to(device), ids.to(device), v)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert ek.scatter_add_rows.launches == before + 3
    for got in runs:
        assert torch.equal(_bits(got.cpu()), _bits(want))
    np.testing.assert_allclose(runs[0].cpu().double().numpy(),
                               exact.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_kernel_at_esmm_width(device, skewed):
    """K1 at ESMM's shared table, C = 16 (DeepFM's fused table is C = 17;
    the segment length depends on C): 16384 ids into 10044 rows, a quarter
    of them on one row as a train batch's busiest movie, or 90% on 16 hot
    rows. Bit for bit its summation order run on the CPU on three calls,
    and within the fp32 summation bound of fp64 (rtol 1e-5, atol 1e-3, as
    at C = 17)."""
    rng = np.random.default_rng(16)
    n, c, v = 16384, 16, 10044
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[rng.random(n) < 0.25] = 7000
    if skewed:
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    ids = torch.from_numpy(ids)
    assert ek.segment_length(c) == 2048
    want = ek.scatter_add_rows_in_segments(g, ids, v)
    exact = ek.scatter_add_rows_reference(g.double(), ids, v)
    for _ in range(3):
        got = ek.scatter_add_rows(g.to(device), ids.to(device), v)
        assert torch.equal(_bits(got.cpu()), _bits(want))
    np.testing.assert_allclose(got.cpu().double().numpy(), exact.numpy(),
                               rtol=1e-5, atol=1e-3)


def _two_tower_batch(batch=4096):
    """One two-tower train batch of the rank-power corpus (20k ratings,
    seed 42) and a TwoTower at the zoo's widths (embedding_dim 32): each
    tower's big-vocab gather takes the batch's user_id or movie_id ids, at
    offset 0 of its (V, 32) table."""
    from deep_recommenders_torch.datasets import MovielensRanking
    from deep_recommenders_torch.models.retrieval import TwoTower

    ds = MovielensRanking(batch_size=batch, num_ratings=20_000, seed=42,
                          movie_popularity="rank-power")
    user, item, _ = ds.retrieval_arrays("train")
    model = TwoTower(ds.user_specs(), ds.item_specs(), embedding_dim=32,
                     generator=torch.Generator().manual_seed(0))
    user = {k: torch.from_numpy(v[:batch]) for k, v in user.items()}
    item = {k: torch.from_numpy(v[:batch]) for k, v in item.items()}
    return model, user, item


@pytest.mark.parametrize("tower", ["query", "candidate"])
def test_scatter_add_rows_kernel_at_two_tower_width(device, tower):
    """K1 at the two-tower's row width C = 32, where the segment is 1024
    ids (2048 x 32 floats do not fit the stage): one train batch's user_id
    (query tower) or movie_id (candidate tower) ids, 4096 of them, into the
    tower's table. Bit for bit its summation order at segment 1024 run on
    the CPU, on three calls, and within the fp32 summation bound of fp64
    (rtol 1e-5, atol 1e-3, as at C = 17)."""
    model, user, item = _two_tower_batch()
    emb = getattr(model, f"{tower}_tower").embeddings
    ids = (user["user_id"] if tower == "query" else item["movie_id"])
    v, c = emb.table.shape
    assert c == 32 and ek.segment_length(c) == 1024
    assert emb.feature_offsets[0] == 0
    g = torch.from_numpy(np.random.default_rng(32).normal(
        0, 1, (ids.shape[0], c)).astype(np.float32))
    want = ek.scatter_add_rows_in_segments(g, ids, v, segment=1024)
    exact = ek.scatter_add_rows_reference(g.double(), ids, v)
    for _ in range(3):
        got = ek.scatter_add_rows(g.to(device), ids.to(device), v)
        assert torch.equal(_bits(got.cpu()), _bits(want))
    np.testing.assert_allclose(got.cpu().double().numpy(), exact.numpy(),
                               rtol=1e-5, atol=1e-3)


def test_two_tower_step_launches_k1_once_a_tower(device, monkeypatch):
    """A two-tower train step on the card (the in-batch loss over 4096
    pairs): two K1 launches, one a tower, each on g (4096, 32) into its
    tower's table, each bit for bit K1's order run on the CPU on the same
    g and ids."""
    from deep_recommenders_torch.ops.retrieval import in_batch_retrieval_loss

    model, user, item = _two_tower_batch()
    model = model.to(device)
    launch, calls = ek.scatter_add_rows, []

    def recording(g, ids, num_rows):
        out = launch(g, ids, num_rows)
        calls.append((g.cpu(), ids.cpu(), num_rows, out.cpu()))
        return out

    # The wrapper counts its launches on the module's scatter_add_rows,
    # which is now this recording one.
    recording.launches = recording.launches_bf16 = 0
    monkeypatch.setattr(ek, "scatter_add_rows", recording)
    qe, ce = model({k: x.to(device) for k, x in user.items()},
                   {k: x.to(device) for k, x in item.items()})
    in_batch_retrieval_loss(qe, ce).backward()
    torch.cuda.synchronize()
    assert recording.launches == 2 and recording.launches_bf16 == 0
    assert sorted(v for _, _, v, _ in calls) == sorted(
        t.embeddings.table.shape[0]
        for t in (model.query_tower, model.candidate_tower))
    for g, ids, v, out in calls:
        assert tuple(g.shape) == (4096, 32)
        want = ek.scatter_add_rows_in_segments(g, ids, v)
        assert torch.equal(_bits(out), _bits(want))


@pytest.mark.parametrize("n,c,v,hot", [
    (16384, 17, 10044, 0.25),     # a train batch: a quarter on one row
    (16384, 17, 1_000_000, 0.0),  # a hashed table: 31 clusters, 2 waves
    (20000, 17, 3, 0.0),          # three rows: every block holds all ids
    (5000, 40, 10044, 0.5),       # wider rows: segments of 512
    (30000, 1, 70000, 0.0),       # one column, several rounds
])
def test_scatter_add_rows_kernel_tables_and_widths(device, n, c, v, hot):
    """K1 bit for bit against its summation order run on the CPU, over two
    calls, at table sizes and row widths that change its plan: the cluster
    count, the segment length and the number of rounds."""
    rng = np.random.default_rng(n + c)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[rng.random(n) < hot] = v // 2
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    ids = torch.from_numpy(ids)
    want = ek.scatter_add_rows_in_segments(g, ids, v)
    for _ in range(2):
        got = ek.scatter_add_rows(g.to(device), ids.to(device), v)
        assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("n,offset", [(40000, 0), (777, 1), (0, 0)])
def test_scatter_add_rows_kernel_ids_out_of_range_and_ragged(device, n,
                                                             offset):
    """Ids in [-V, 0) wrap to row V + id, the rest outside [0, V) drop, as
    in the kernel's summation order run on the CPU (bit for bit); also more
    ids than one round of the kernel (40000), ids not 16-byte aligned (a
    view at offset 1) and no ids at all (every row written 0)."""
    rng = np.random.default_rng(n)
    v, c = 300, 9
    ids = rng.integers(-2 * v, 2 * v, n + offset).astype(np.int32)
    if n > 1000:  # a hot row that spans the chunks
        ids[rng.random(n + offset) < 0.5] = -1
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    ids = torch.from_numpy(ids)[offset:]
    want = ek.scatter_add_rows_in_segments(g, ids, v)
    ids_card = ids.to(device)
    if offset:  # the same ids at an address 4 bytes past 16-byte aligned
        base = torch.zeros(n + offset, dtype=torch.int32, device=device)
        base[offset:] = ids_card
        ids_card = base[offset:]
        assert ids_card.data_ptr() % 16 != 0
    before = ek.scatter_add_rows.launches
    got = ek.scatter_add_rows(g.to(device), ids_card, v)
    torch.cuda.synchronize()
    assert ek.scatter_add_rows.launches == before + 1
    assert torch.equal(_bits(got.cpu()), _bits(want))


def test_scatter_add_rows_writes_untouched_rows_over_nan_memory(device):
    """The output is allocated uninitialised: rows no id touches must come
    out +0.0 even where the caching allocator hands back memory first
    filled with NaN."""
    v, c = 10044, 17
    ids = torch.arange(0, v, 7, dtype=torch.int32, device=device)
    g = torch.ones(ids.shape[0], c, device=device)
    garbage = torch.full((v, c), float("nan"), device=device)
    ptr = garbage.data_ptr()
    del garbage
    got = ek.scatter_add_rows(g, ids, v)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr  # the NaN-filled block, reused
    want = torch.zeros(v, c)
    want[::7] = 1.0
    assert torch.equal(_bits(got.cpu()), _bits(want))


def test_lookup_backward_launches_kernel_once(device):
    table = torch.randn(100, 17, device=device, requires_grad=True)
    ids = torch.randint(0, 100, (64, 2), device=device, dtype=torch.int32)
    before = ek.scatter_add_rows.launches
    ek.lookup(table, ids).square().sum().backward()
    assert ek.scatter_add_rows.launches == before + 1
    want = ek.scatter_add_rows_reference(
        2 * table.detach()[ids.long()].reshape(-1, 17), ids.reshape(-1), 100
    )
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)


def test_scatter_add_rows_rejects_bad_inputs(device):
    g = torch.zeros(4, 3, device=device)
    with pytest.raises(TypeError):
        ek.scatter_add_rows(g, torch.zeros(4, dtype=torch.int64,
                                           device=device), 5)
    with pytest.raises(TypeError):
        ek.scatter_add_rows(g.double(), torch.zeros(4, dtype=torch.int32,
                                                    device=device), 5)


def _k1_bf16_ids(rng, n, v, kind):
    ids = rng.integers(0, v, n).astype(np.int32)
    if kind == "batch":  # a train batch: a quarter of the ids on one row
        ids[rng.random(n) < 0.25] = v // 2
    elif kind == "skewed":  # 90% of the ids on 16 hot rows
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    return torch.from_numpy(ids)


@pytest.mark.parametrize("n,c,v,kind", [
    (16384, 17, 10044, "batch"),    # DeepFM's fused pass, one round
    (16384, 17, 10044, "skewed"),
    (16384, 17, 10044, "uniform"),
    (16384, 16, 10044, "batch"),    # xDeepFM's embeddings
    (8192, 1, 10044, "batch"),      # a linear pass
    (16383, 17, 10044, "skewed"),   # an odd N: a ragged last segment
    (777, 17, 300, "uniform"),
    (40001, 17, 300, "batch"),      # more than one round: the workspace
    (30000, 1, 70000, "uniform"),   # one column, rounds over a big table
    (0, 17, 50, "uniform"),         # no ids: every row +0.0
])
def test_scatter_add_rows_bf16_kernel(device, n, c, v, kind):
    """K1 on bf16 g: bit for bit ``scatter_add_rows_in_segments(g.float(),
    ids, V).to(bf16)`` run on the CPU (fp32 sums in K1's order, each row
    rounded once), over two calls, each counted in
    ``scatter_add_rows.launches_bf16`` and not in the fp32 counter."""
    rng = np.random.default_rng(n + c + v)
    ids = _k1_bf16_ids(rng, n, v, kind)
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(torch.bfloat16)
    want = ek.scatter_add_rows_in_segments(g.float(), ids, v).to(
        torch.bfloat16)
    before = (ek.scatter_add_rows.launches, ek.scatter_add_rows.launches_bf16)
    for _ in range(2):
        got = ek.scatter_add_rows(g.to(device), ids.to(device), v)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (v, c)
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))
    assert (ek.scatter_add_rows.launches,
            ek.scatter_add_rows.launches_bf16) == (before[0], before[1] + 2)


def test_scatter_add_rows_bf16_at_an_odd_address(device):
    """bf16 rows of 34 bytes from a base 2 bytes past a 4-byte boundary,
    over NaN-filled output memory: bit for bit as above."""
    rng = np.random.default_rng(5)
    n, c, v = 5001, 17, 777
    ids = _k1_bf16_ids(rng, n, v, "skewed")
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(torch.bfloat16)
    want = ek.scatter_add_rows_in_segments(g.float(), ids, v).to(
        torch.bfloat16)
    base = torch.zeros(n * c + 1, dtype=torch.bfloat16, device=device)
    base[1:] = g.reshape(-1).to(device)
    g_card = base[1:].view(n, c)
    assert g_card.data_ptr() % 4 == 2
    garbage = torch.full((v, c), float("nan"), dtype=torch.bfloat16,
                         device=device)
    del garbage
    got = ek.scatter_add_rows(g_card, ids.to(device), v)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_lookup_backward_on_a_bf16_table(device):
    """A bf16 cast of an fp32 table: the lookup's backward launches the
    bf16 K1 once and the cast's backward upcasts its rows: the fp32
    parameter's gradient is the bf16 result, exactly."""
    table = torch.randn(1000, 17, device=device, requires_grad=True)
    ids = torch.randint(0, 1000, (512, 2), device=device, dtype=torch.int32)
    g = torch.randn(512, 2, 17, device=device).to(torch.bfloat16)
    before = (ek.scatter_add_rows.launches, ek.scatter_add_rows.launches_bf16)
    ek.lookup(table.to(torch.bfloat16), ids).backward(g)
    assert (ek.scatter_add_rows.launches,
            ek.scatter_add_rows.launches_bf16) == (before[0], before[1] + 1)
    want = ek.scatter_add_rows_in_segments(
        g.reshape(-1, 17).float().cpu(), ids.reshape(-1).cpu(), 1000)
    assert table.grad.dtype == torch.float32
    assert torch.equal(table.grad.cpu(), want.to(torch.bfloat16).float())


def test_bf16_table_train_step_launches_k1_once(device):
    """A table stored in bf16 (``EmbeddingCollection(param_dtype=bf16)``)
    beside fp32 linear terms in one fused pass, as DeepFM composes them,
    on a train batch of 8192: the step launches the bf16 K1 once and the
    fp32 K1 never; the table's gradient is that launch's rows bit for bit
    its order model's on the step's own g and ids; the port's Adam keeps
    the table and its moments bf16."""
    from deep_recommenders_torch.datasets.movielens import (
        default_movielens_features,
    )
    from deep_recommenders_torch.embedding.engine import (
        EmbeddingCollection,
        LinearTerms,
        fused_embedding_linear,
    )
    from deep_recommenders_torch.training import Adam

    specs = default_movielens_features()
    emb = EmbeddingCollection(specs, 16, param_dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
    lin = LinearTerms(specs)
    emb, lin = emb.to(device), lin.to(device)
    rng = np.random.default_rng(4)
    b = 8192
    batch = {"user_id": rng.integers(0, 6040, b),
             "user_gender": rng.integers(0, 3, b),
             "user_age": rng.integers(0, 8, b),
             "user_occupation": rng.integers(0, 22, b),
             "movie_id": rng.integers(0, 3952, b),
             "movie_genres": rng.integers(0, 19, (b, 6))}
    batch = {k: torch.from_numpy(v.astype(np.int32)).to(device)
             for k, v in batch.items()}
    batch["movie_genres__wt"] = (torch.rand(b, 6, device=device)
                                 < 0.5).float()
    opt = Adam([*emb.parameters(), *lin.parameters()], lr=1e-3)
    seen, real = {}, ek.scatter_add_rows

    def keep(g, ids, num_rows):
        ek.scatter_add_rows = real
        seen.update(g=g.clone(), ids=ids.clone(), num_rows=num_rows)
        return real(g, ids, num_rows)

    before = (ek.scatter_add_rows.launches, ek.scatter_add_rows.launches_bf16)
    ek.scatter_add_rows = keep
    try:
        stacked, first = fused_embedding_linear(emb, lin, batch)
        ((stacked.float() ** 2).sum() + first.sum()).backward()
    finally:
        ek.scatter_add_rows = real
    assert (ek.scatter_add_rows.launches,
            ek.scatter_add_rows.launches_bf16) == (before[0], before[1] + 1)
    g, ids = seen["g"], seen["ids"]
    assert g.dtype == emb.table.grad.dtype == torch.bfloat16
    want = ek.scatter_add_rows_in_segments(
        g.float().cpu(), ids.cpu(), seen["num_rows"]).to(torch.bfloat16)
    # the big-vocab rows are K1's alone: the small vocabs go through the
    # one-hot matmul, whose gradient adds to theirs
    big = torch.zeros(seen["num_rows"], dtype=torch.bool)
    big[ids.long().cpu()] = True
    for s, off in zip(specs, emb.feature_offsets):
        if s.cardinality <= 256:
            big[off:off + s.cardinality] = False
    got = emb.table.grad.cpu()[big].view(torch.int16)
    assert torch.equal(got, want[big, :16].contiguous().view(torch.int16))
    before_step = emb.table.detach().clone()
    opt.step()
    state = opt.state[emb.table]
    assert emb.table.dtype == state["exp_avg"].dtype == torch.bfloat16
    assert state["exp_avg_sq"].dtype == torch.bfloat16
    assert not torch.equal(emb.table.detach(), before_step)


def test_scatter_add_rows_rejects_other_dtypes(device):
    """fp32 and bf16 g only: no silent cast, no fallback."""
    ids = torch.zeros(4, dtype=torch.int32, device=device)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            ek.scatter_add_rows(torch.zeros(4, 3, dtype=dtype,
                                            device=device), ids, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 6, 16), (5, 3, 70), (1, 1, 1),
                                   (1000, 7, 20)])
def test_fm_interaction_kernel(device, shape, dtype):
    """K2 on fp32 and bf16 embeddings, through its vector path (16-byte
    loads, several rows a warp) and its scalar branch (D = 70, 1, 20: not
    a multiple of the vector width, or more than 32 lanes a row), against
    the plain version on the CPU on the same values: both sum fp32 values
    in fp32 in other orders."""
    emb = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    emb = emb.to(dtype)
    want = fm.fm_interaction(emb)
    before = fm.fm_interaction_fused.launches
    got = fm.fm_interaction_fused(emb.to(device))
    torch.cuda.synchronize()
    assert fm.fm_interaction_fused.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def _normal(gen, *shape, std=1.0):
    return torch.randn(*shape, device=gen.device, generator=gen) * std


@pytest.mark.parametrize("r,f0,h,m", [
    (131072, 6, 128, 128),  # the layered xDeepFM's layers 1 and 2
    (131072, 6, 6, 128),  # its layer 0 (H = F0)
    (1000, 6, 20, 12),
    (37, 3, 130, 200),  # two column tiles each way, one partial row tile
])
def test_cin2d_kernel(device, r, f0, h, m):
    """K4's forward and backward at the TPU kernel's bf16 contract, each
    held against its bf16 emulation and against fp64
    (ops/cin_tolerances.py), one launch each."""
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    g = _normal(gen, r, m)
    before = dict(ck.cin2d.launches)
    out = ck.cin2d_forward(x0, x, w)
    grads = ck.cin2d_backward(x0, x, w, g)
    assert ck.cin2d.launches == {"fwd": before["fwd"] + 1,
                                 "bwd": before["bwd"] + 1}
    ct.check_cin2d_forward(out, x0, x, w)
    ct.check_cin2d_backward(grads, x0, x, w, g)


def test_cin2d_autograd_launches_both_kernels(device):
    gen = torch.Generator(device=device).manual_seed(1)
    x0, x = _normal(gen, 4096, 6), _normal(gen, 4096, 128)
    w, g = _normal(gen, 6, 128, 128, std=0.05), _normal(gen, 4096, 128)
    args = [t.clone().requires_grad_() for t in (x0, x, w)]
    before = dict(ck.cin2d.launches)
    out = ck.cin2d(*args)
    out.backward(g)
    assert ck.cin2d.launches == {"fwd": before["fwd"] + 1,
                                 "bwd": before["bwd"] + 1}
    ct.check_cin2d_forward(out.detach(), x0, x, w)
    ct.check_cin2d_backward([a.grad for a in args], x0, x, w, g)


@pytest.mark.parametrize("h", [128, 6])
def test_cin2d_backward_check_rejects_planted_faults(device, h):
    """At the layered xDeepFM's shapes, on the card: K4's backward passes,
    and its check rejects dW scaled by 1 + 1e-3, dW less one weight chunk
    of rows, and the fp32 function."""
    gen = torch.Generator(device=device).manual_seed(5)
    x0 = _normal(gen, 131072, 6, std=0.25)
    x = x0 if h == 6 else torch.relu(_normal(gen, 131072, h, std=0.25))
    w = _normal(gen, 6, h, 128, std=0.05)
    g = _normal(gen, 131072, 128)
    checks = ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x,
                                     w, g, planted_rows=ct.PLANTED_ROWS)
    assert set(checks["planted"]) == {"fp32", "dw_scaled_1e-3",
                                      "dw_chunk_dropped"}
    assert min(checks["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


def test_cin2d_forward_check_rejects_planted_outputs(device):
    """At the layered xDeepFM's shape, on the card: the fp32 function and
    the bf16 emulation without one f-slice both fail the forward check."""
    gen = torch.Generator(device=device).manual_seed(4)
    x0 = _normal(gen, 131072, 6, std=0.25)
    x = torch.relu(_normal(gen, 131072, 128, std=0.25))
    w = _normal(gen, 6, 128, 128, std=0.05)
    checks = ct.check_cin2d_forward(ck.cin2d_forward(x0, x, w), x0, x, w,
                                    planted=True)
    assert min(checks["bf16"]["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


def _stack_inputs(gen, b, f0, d, m1, m2, std=0.05):
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=std)
    w2 = _normal(gen, f0, m1, m2, std=std)
    return x0, w1, w2, _normal(gen, b, m1), _normal(gen, b, m2)


@pytest.mark.parametrize("b,f0,d,m1,m2", [
    (8192, 6, 16, 128, 128),  # the flagship xDeepFM
    (16, 6, 8, 12, 20),
    (5, 6, 3, 7, 5),  # R = 15 rows
    (9, 4, 70, 130, 200),  # examples over three blocks; two column tiles
    (300, 6, 1, 128, 128),  # one row an example
    (100, 6, 3, 128, 128),  # examples across block edges
    (5, 6, 129, 128, 128),  # the longest example over two blocks at most
])
def test_cin_stack_kernel(device, b, f0, d, m1, m2):
    """K3's forward, with and without residuals, against its bf16
    emulation and fp64; its backward on the forward's bf16 residuals."""
    gen = torch.Generator(device=device).manual_seed(2)
    x0, w1, w2, gp1, gp2 = _stack_inputs(gen, b, f0, d, m1, m2)
    before = dict(ck.cin_stack_pooled.launches)
    got = ck.stack_forward(x0, w1, w2, d, residuals=True)
    assert got[2].dtype == got[3].dtype == torch.bfloat16
    ct.check_stack_forward(got, x0, w1, w2, d)
    bare = ck.stack_forward(x0, w1, w2, d, residuals=False)
    assert bare[2] is None and bare[3] is None
    ct.check_stack_forward(bare, x0, w1, w2, d)
    # p is deterministic where an example spans at most two blocks.
    torch.testing.assert_close(bare[0], got[0], rtol=0, atol=0)
    torch.testing.assert_close(bare[1], got[1], rtol=0, atol=0)

    z1, z2 = got[2], got[3]
    grads = ck.stack_backward(x0, w1, w2, z1, z2, gp1, gp2)
    assert grads[0].dtype == torch.bfloat16
    ct.check_stack_backward(grads, x0, w1, w2, z1, z2, gp1, gp2)
    assert ck.cin_stack_pooled.launches == {"fwd": before["fwd"] + 2,
                                            "bwd": before["bwd"] + 1}


def test_cin_stack_forward_check_rejects_planted_faults(device):
    """At the flagship xDeepFM's shape, on the card: K3's forward passes,
    and its check rejects the fp32 function, W2 without one f-slice, z1
    left unrounded before layer 2 and W scaled by 1 + 1e-3."""
    gen = torch.Generator(device=device).manual_seed(5)
    x0, w1, w2, _, _ = _stack_inputs(gen, 8192, 6, 16, 128, 128)
    checks = ct.check_stack_forward(ck.stack_forward(x0, w1, w2, 16), x0,
                                    w1, w2, 16, planted=True)
    assert len(checks["planted"]) == 4
    assert min(checks["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


@pytest.mark.parametrize("f0,m1,fits", [
    (18, 128, True),  # 512 F0 + 256 (K1p + K2p + 16) + 256 (K1p + 8)
    (19, 128, False),  # K1p = 368: 237056 bytes
    (6, 688, True),  # 512 F0 + 256 (K1p + K2p + 16) + 36864 = 232448
    (6, 689, False),  # K2p = 704
])
def test_cin_stack_forward_at_its_shared_memory_limit(device, f0, m1, fits):
    """K3's forward runs and passes its check up to the shapes whose block
    fits in shared memory, and refuses the next with a ValueError."""
    gen = torch.Generator(device=device).manual_seed(10)
    x0, w1, w2, _, _ = _stack_inputs(gen, 20, f0, 16, m1, 24, std=0.02)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            ck.stack_forward(x0, w1, w2, 16)
        return
    ct.check_stack_forward(ck.stack_forward(x0, w1, w2, 16), x0, w1, w2, 16)


def test_cin_stack_backward_check_rejects_planted_faults(device):
    """At the flagship xDeepFM's shape, on the card: K3's backward passes,
    and its check rejects each dW scaled by 1 + 1e-3 and less one weight
    chunk of rows, and the fp32 function."""
    gen = torch.Generator(device=device).manual_seed(6)
    d = 16
    x0, w1, w2, gp1, gp2 = _stack_inputs(gen, 8192, 6, d, 128, 128)
    _, _, z1, z2 = ck.stack_forward(x0, w1, w2, d, residuals=True)
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(ck.stack_backward(*args), *args,
                                     planted_rows=ct.PLANTED_ROWS)
    assert len(checks["planted"]) == 5
    assert min(checks["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


def test_cin_stack_pooled_autograd_and_no_grad_launches(device):
    gen = torch.Generator(device=device).manual_seed(3)
    x0 = _normal(gen, 64 * 16, 6, std=0.25).to(torch.bfloat16)
    x0.requires_grad_()
    w1 = _normal(gen, 6, 6, 16, std=0.05).requires_grad_()
    w2 = _normal(gen, 6, 16, 24, std=0.05).requires_grad_()
    before = dict(ck.cin_stack_pooled.launches)
    p1, p2 = ck.cin_stack_pooled(x0, w1, w2, 16)
    (p1.sum() + p2.square().sum()).backward()
    with torch.no_grad():
        q1, q2 = ck.cin_stack_pooled(x0, w1, w2, 16)
    assert ck.cin_stack_pooled.launches == {"fwd": before["fwd"] + 2,
                                            "bwd": before["bwd"] + 1}
    torch.testing.assert_close(q1, p1.detach(), rtol=0, atol=0)
    assert x0.grad.dtype == torch.bfloat16 and w1.grad.shape == w1.shape
    assert bool(torch.isfinite(w2.grad).all())


@pytest.mark.parametrize("f0,h,m,fits", [
    (55, 128, 128, True),  # 256 Mp + 1024 F0 = 89088, the limit
    (56, 128, 128, False),
    (6, 128, 320, True),
    (6, 128, 321, False),  # Mp = 336
    (171, 6, 128, True),  # H <= 16: 256 Mp + 1024 F0 <= 208384
    (172, 6, 128, False),
])
def test_cin2d_backward_at_its_shared_memory_limit(device, f0, h, m, fits):
    """K4's backward runs and passes its check up to the shapes whose data
    block fits in shared memory, and refuses the next with a ValueError."""
    gen = torch.Generator(device=device).manual_seed(8)
    r = 300
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    g = _normal(gen, r, m)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            ck.cin2d_backward(x0, x, w, g)
        return
    ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x, w, g)


@pytest.mark.parametrize("f0,fits", [(55, True), (56, False)])
def test_cin_stack_backward_at_its_shared_memory_limit(device, f0, fits):
    """K3's backward at M1 = M2 = 128 runs and passes its check up to
    F0 = 55 (256 (K2p + 2 K1p) + 1024 F0 = 154624) and refuses F0 = 56.
    The forward takes F0 <= 18, so the bf16 residuals come from its
    emulation."""
    gen = torch.Generator(device=device).manual_seed(9)
    d = 16
    x0, w1, w2, gp1, gp2 = _stack_inputs(gen, 20, f0, d, 128, 128,
                                         std=0.02)
    _, _, z1, z2 = ck.stack_forward_reference_bf16(x0, w1, w2, d)
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            ck.stack_backward(*args)
        return
    ct.check_stack_backward(ck.stack_backward(*args), *args)


def test_cin_kernels_reject_bad_inputs(device):
    x0, x = torch.zeros(64, 6, device=device), torch.zeros(64, 8,
                                                           device=device)
    w = torch.zeros(6, 8, 4, device=device)
    with pytest.raises(TypeError):
        ck.cin2d_forward(x0.double(), x, w)
    with pytest.raises(TypeError):
        ck.cin2d_forward(x0, x, torch.zeros(6, 7, 4, device=device))
    with pytest.raises(ValueError):
        ck.cin2d_forward(x0, x, w.cpu())
    with pytest.raises(ValueError):
        ck.cin2d_forward(x0, torch.zeros(8, 64, device=device).T, w)
    with pytest.raises(TypeError):
        ck.cin2d_backward(x0, x, w, torch.zeros(64, 5, device=device))
    w1 = torch.zeros(6, 6, 4, device=device)
    w2 = torch.zeros(6, 4, 4, device=device)
    with pytest.raises(TypeError):  # the stack reads bf16 rows
        ck.stack_forward(x0, w1, w2, 16)
    with pytest.raises(ValueError):  # rows that are not whole examples
        ck.stack_forward(x0.to(torch.bfloat16), w1, w2, 10)
    z = torch.zeros(64, 4, device=device)
    gp = torch.zeros(4, 4, device=device)
    with pytest.raises(TypeError):
        ck.stack_backward(x0.to(torch.bfloat16), w1, w2, z, z, gp,
                          torch.zeros(4, 5, device=device))
    with pytest.raises(TypeError):  # the residuals are bf16 on the card
        ck.stack_backward(x0.to(torch.bfloat16), w1, w2, z, z, gp, gp)


# -- K5 and K6 ----------------------------------------------------------------

def _attention_inputs(gen, bh, sq, sk, d):
    q, k, v = (_normal(gen, bh, s, d) for s in (sq, sk, sk))
    mask = (torch.rand(bh, sk, device=gen.device, generator=gen) < 0.8).float()
    mask[1] = 0.0  # a (bh) row with no valid key
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (6, 150, 130, 16),  # ragged tiles both ways, Sq != Sk
    (6, 130, 150, 32),
    (4, 64, 200, 64),
    (4, 100, 100, 128),
    (4, 100, 140, 256),  # K6 of flash_attention_wide.cu, k/v resident
    (4, 100, 140, 320),  # K5, K6 above 256: clusters of 2 blocks, 3 + 2 chunks
    (2, 130, 70, 512),  # 2 blocks, 4 + 4
    (2, 100, 140, 768),  # 3 blocks
    (2, 70, 67, 2304),  # two grid columns of clusters of 5 blocks
    (64, 512, 512, 16),  # the Transformer slice's sequence length
])
def test_flash_attention_kernels(device, bh, sq, sk, d, causal):
    """K5 and K6 against their fp64 plain versions
    (ops/attention_tolerances.py states the tolerances), one launch each;
    the check rejects dk less one query tile."""
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    g = _normal(gen, bh, sq, d)
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    at.check_forward((out, lse), q, k, v, mask, causal)
    checks = at.check_backward(grads, q, k, v, mask, out, lse, g, causal,
                               planted_rows=64)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    # The row with no valid key: out 0, lse 0, and no gradient.
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert not grad[1].any()


def _edge_mask(mask, case, sk):
    """Key masks the fp32 kernels must skip or mask at a tile's edge."""
    last = (sk - 1) // 64 * 64  # the first key of the last 64-key tile
    if case == "padding_tiles":
        mask[:, 64:128] = 0.0  # a whole middle tile of padding: skipped
        mask[2, last:] = 0.0  # post-padding: the last tile too
    elif case == "last_tile_only":
        mask[0] = 0.0
        mask[0, last:] = 1.0  # row 0's only valid keys: the last tile
        mask[3] = 0.0
        mask[3, sk - 1] = 1.0  # row 3's only valid key: the last one
    return mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d", [
    ("padding_tiles", 6, 200, 300, 16),
    ("padding_tiles", 4, 130, 260, 128),
    ("last_tile_only", 6, 150, 200, 16),
    ("last_tile_only", 4, 100, 140, 64),
    ("ragged_sk", 4, 70, 67, 16),  # Sk not a multiple of 8
    ("ragged_sk", 4, 33, 61, 32),
    ("padding_tiles", 4, 130, 260, 256),
    ("last_tile_only", 4, 100, 140, 256),
    ("ragged_sk", 4, 70, 67, 256),
    ("ragged_sk", 4, 33, 61, 256),
    ("padding_tiles", 4, 130, 260, 320),
    ("last_tile_only", 4, 100, 140, 512),
    ("ragged_sk", 4, 70, 67, 320),
    ("ragged_sk", 2, 33, 61, 512),
    ("padding_tiles", 4, 130, 260, 768),
    ("last_tile_only", 4, 100, 140, 2304),
])
def test_flash_attention_kernels_at_tile_edges(device, case, bh, sq, sk, d,
                                               causal):
    """K5 and K6 where whole 64-key tiles are padding (skipped), where a
    row's only valid keys lie in the last tile, and where Sk is not a
    multiple of 8 (the ragged edge of the P V fragments' 2t / 2t + 1 key
    rows): against their fp64 plain versions, one launch each."""
    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _edge_mask(mask, case, sk)
    g = _normal(gen, bh, sq, d)
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    at.check_forward((out, lse), q, k, v, mask, causal)
    at.check_backward(grads, q, k, v, mask, out, lse, g, causal)
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert not grad[1].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_checks_reject_single_pass_tf32(device, causal):
    """At the slice's sequence length, the checks reject the function with
    single-pass TF32 products on the card's data at least
    TF32_REJECT_FACTOR times over their limits, forward and backward, and
    accept the kernels."""
    gen = torch.Generator(device=device).manual_seed(10)
    q, k, v, mask = _attention_inputs(gen, 32, 512, 512, 16)
    mask[4:, 320:] = 0.0  # SyntheticImdb-like post-padding
    g = _normal(gen, 32, 512, 16)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    fwd = at.check_forward((out, lse), q, k, v, mask, causal,
                           planted_tf32=True)
    bwd = at.check_backward(grads, q, k, v, mask, out, lse, g, causal,
                            planted_tf32=True)
    for checks in (fwd, bwd):
        assert checks["planted"]["single_pass_tf32"] >= \
            at.TF32_REJECT_FACTOR


def test_flash_attention_autograd_launches_both_kernels(device):
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, mask = _attention_inputs(gen, 16, 200, 200, 16)
    g = _normal(gen, 16, 200, 16)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, mask, True)
    out.backward(g)
    with torch.no_grad():
        att.FlashAttention.apply(q, k, v, mask, True)
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1}
    # The forward is deterministic: this lse is the one the backward used.
    again, lse = att.flash_attention(q, k, v, mask, True, return_lse=True)
    assert torch.equal(again, out.detach())
    at.check_backward([a.grad for a in args], q, k, v, mask, again, lse, g,
                      True)


def test_attention_dispatch_on_the_card(device):
    """The slice's shape goes through K5 and K6 unasked; a short sequence
    goes dense, and so does dropout, with a warning above the budget."""
    gen = torch.Generator(device=device).manual_seed(6)
    before = dict(att.flash_attention.launches)
    q = _normal(gen, 2048, 512, 16).requires_grad_()
    att.attention(q, q, q, causal=True).sum().backward()
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    small = _normal(gen, 2048, 256, 16)
    att.attention(small, small, small)
    with pytest.warns(UserWarning, match="memory budget"):
        att.attention(q.detach(), q.detach(), q.detach(), dropout_rate=0.1,
                      generator=gen)
    assert att.flash_attention.launches["fwd"] == before["fwd"] + 1


def test_flash_attention_rejects_bad_inputs(device):
    q = torch.zeros(2, 8, 16, device=device)
    mask = torch.ones(2, 8, device=device)
    with pytest.raises(ValueError):  # no kernel for D = 24
        z = torch.zeros(2, 8, 24, device=device)
        att.flash_attention(z, z, z, mask)
    with pytest.raises(TypeError):
        att.flash_attention(q.double(), q.double(), q.double(), mask.double())
    with pytest.raises(ValueError):
        t = torch.zeros(2, 16, 8, device=device).transpose(1, 2)
        att.flash_attention(t, t, t, mask)
    with pytest.raises(TypeError):
        att.flash_attention(q, q, q, torch.ones(2, 7, device=device))
    with pytest.raises(ValueError):
        att.flash_attention(q, q.cpu(), q, mask)


# -- K5 and K6 in bf16 --------------------------------------------------------

def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (6, 150, 130, 16),  # ragged tiles both ways, Sq != Sk
    (6, 130, 150, 32),
    (4, 64, 200, 64),
    (4, 100, 100, 128),
    (4, 100, 140, 256),  # K5 of flash_attention_cluster_bf16.cu, one
    (4, 70, 67, 256),  # block (Sq not a multiple of its 128 rows a block,
    (4, 130, 200, 256),  # causal rows split between its warpgroups), K6 of
    # _wide_bf16.cu
    (4, 100, 140, 320),  # K5 on a cluster of 2 blocks, the last chunk past D
    (4, 70, 67, 512),  # 2 blocks, 4 + 4 chunks
    (3, 100, 140, 576),  # 3 blocks of 3 chunks
    (3, 100, 140, 768),  # 3 blocks
    (3, 70, 67, 2304),  # above 2048: K5 on a cluster of 9 blocks (reduce-
    # scatter), K6 of flash_attention_wide_bf16.cu
    (64, 512, 512, 16),  # the Transformer slice's sequence length
])
def test_flash_attention_bf16_kernels(device, bh, sq, sk, d, causal):
    """The bf16 K5 and K6 against their fp64 and bf16 plain versions
    (ops/attention_tolerances.py states the tolerances), one launch each
    and no fp32 launch; the check rejects dk less one query tile."""
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask[2, sk // 2:] = 0.0  # post-padding: whole key tiles of padding
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    at.check_forward_bf16((out, lse), q, k, v, mask, causal)
    checks = at.check_backward_bf16(grads, q, k, v, mask, out, lse, g,
                                    causal, planted_rows=64)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert grad.dtype == torch.bfloat16 and not grad[1].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d", [
    ("padding_tiles", 4, 130, 260, 256),
    ("padding_tiles", 4, 70, 260, 256),
    ("last_tile_only", 4, 100, 140, 256),
    ("ragged_sk", 4, 33, 61, 256),
    ("padding_tiles", 4, 130, 260, 320),
    ("last_tile_only", 4, 100, 140, 512),
    ("ragged_sk", 4, 70, 67, 320),
    ("ragged_sk", 2, 33, 61, 512),
    ("padding_tiles", 4, 130, 260, 768),
    ("last_tile_only", 4, 100, 140, 2304),
])
def test_flash_attention_bf16_kernels_at_tile_edges(device, case, bh, sq, sk,
                                                    d, causal):
    """The bf16 K5/K6 at D = 256 and above it where whole 64-key tiles
    are padding (skipped), where a row's only valid keys lie in the last
    tile, and at ragged Sq and Sk: against their fp64 and bf16 plain
    versions, one launch each."""
    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _edge_mask(mask, case, sk)
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    at.check_forward_bf16((out, lse), q, k, v, mask, causal)
    at.check_backward_bf16(grads, q, k, v, mask, out, lse, g, causal)
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert grad.dtype == torch.bfloat16 and not grad[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 320, 512, 768, 1024, 2048, 2304])
def test_wide_attention_kernels_are_deterministic(device, d, dtype):
    """K5 and K6 from D = 256 on give the same bits on two calls: each
    block writes its own rows once, the two warpgroups' partial sums are
    added in a fixed order, and a cluster that splits D (K5 and K6 in both
    dtypes; the bf16 clusters of 2, 3, 4 and 8 blocks at D = 320-512, 768,
    1024 and 2048, and the bf16 K6 past them at 2304) adds its blocks'
    partial scores in rank order."""
    gen = torch.Generator(device=device).manual_seed(14)
    q, k, v, mask = _attention_inputs(gen, 8, 300, 260, d)
    g = _normal(gen, 8, 300, d)
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    runs = []
    for _ in range(2):
        out, lse = att.flash_attention(q, k, v, mask, True, return_lse=True)
        runs.append((out, lse, *att.flash_attention_backward(
            q, k, v, mask, out, lse, g, True)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (4, 130, 200, 320),  # a cluster of 2 blocks (push), the last chunk past D
    (4, 100, 140, 512),
    (3, 70, 67, 768),  # 3 blocks (pull)
    (2, 130, 260, 1024),  # 4 blocks
    (2, 70, 67, 2048),  # 8 blocks
])
def test_cluster_bf16_backward(device, bh, sq, sk, d, causal):
    """The bf16 K6 above 256 on clusters that split D
    (csrc/flash_attention_cluster_bf16.cu): one launch, against its fp64
    and bf16 plain versions; the checks reject dk less a query tile, dq
    less a key tile and the backward that loses the last block's partial
    scores; two calls give the same bits."""
    gen = torch.Generator(device=device).manual_seed(15)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask[2 % bh, sk // 2:] = 0.0  # post-padding: whole key tiles of padding
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    assert att._kernel(torch.bfloat16, d, True)[0] == \
        "flash_attention_cluster_bf16"
    before = att.flash_attention.launches["bwd_bf16"]
    runs = [att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert att.flash_attention.launches["bwd_bf16"] == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    checks = at.check_backward_bf16(runs[0], q, k, v, mask, out, lse, g,
                                    causal, planted_rows=64, planted_keys=64,
                                    planted_partial=True)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    assert checks["dq"]["planted"]["key_tile_dropped"] > 1
    assert checks["planted"]["partial_dropped"] > 1
    for grad in runs[0]:
        assert not grad[1].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d", [
    ("ragged", 4, 150, 130, 64),  # Sq != Sk, neither a multiple of 64
    ("padding_tiles", 6, 130, 260, 64),  # whole 64-key tiles of padding
    ("last_tile_only", 4, 100, 140, 128),  # a row's only keys: the last tile
    ("padding_tiles", 5, 70, 200, 128),  # Sq under one 128-row item
    # More items than the card's SMs: each block of the persistent grids
    # walks several (bh, 128-row) items.
    ("ragged", 300, 130, 200, 128),
    ("padding_tiles", 140, 520, 260, 64),
    ("last_tile_only", 133, 33, 61, 64),
])
def test_cluster_bf16_narrow_kernels(device, case, bh, sq, sk, d, causal):
    """The one-block instances of flash_attention_cluster_bf16.cu: the bf16
    K6 at D = 64 and 128 (dq_solo and dkv_solo) and K5 at D = 128
    (fwd_solo), all on persistent grids, at ragged and tile-edge shapes
    and with fewer and more (bh) than SMs: one launch each a call, two
    calls bit for bit, against their fp64 and bf16 plain versions; the
    checks reject dk less its first query tile and dq less its first key
    tile. A row with no valid key gives out 0, lse 0 and no gradient."""
    gen = torch.Generator(device=device).manual_seed(24)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _edge_mask(mask, case, sk)
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    assert att._kernel(torch.bfloat16, d, True)[0] == \
        "flash_attention_cluster_bf16"
    assert att._kernel(torch.bfloat16, d, False)[0] == (
        "flash_attention_cluster_bf16" if d == 128
        else "flash_attention_tma_bf16")
    before = dict(att.flash_attention.launches)
    runs = []
    for _ in range(2):
        out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
        runs.append((out, lse, *att.flash_attention_backward(
            q, k, v, mask, out, lse, g, causal)))
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 2,
        "bwd_bf16": before["bwd_bf16"] + 2}
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, lse, *grads = runs[0]
    at.check_forward_bf16((out, lse), q, k, v, mask, causal)
    planted_keys = 64 if case != "last_tile_only" else 0
    checks = at.check_backward_bf16(grads, q, k, v, mask, out, lse, g,
                                    causal, planted_rows=64,
                                    planted_keys=planted_keys)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    if planted_keys:
        assert checks["dq"]["planted"]["key_tile_dropped"] > 1
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert grad.dtype == torch.bfloat16 and not grad[1].any()


# -- the bf16 K5 and K6 of flash_attention_tma_bf16.cu --------------------------

def _tma_edge_mask(mask, case, sk):
    """Key masks at the tiles of flash_attention_tma_bf16.cu (K5's of 64
    keys, K6's of 128): a whole middle 128-key tile of padding (never
    loaded) and post-padding in the last; a row whose only valid keys lie
    in the last 128 keys, and one whose only valid key is the last;
    post-padding that ends inside a tile (a half tile with no valid key
    skipped, the other half masked)."""
    last = (sk - 1) // 128 * 128  # the first key of the last 128-key tile
    if case == "padding_tiles":
        mask[:, 128:256] = 0.0
        mask[2, last:] = 0.0
    elif case == "last_tile_only":
        mask[0] = 0.0
        mask[0, last:] = 1.0
        mask[3] = 0.0
        mask[3, sk - 1] = 1.0
    elif case == "post_padding":
        lengths = torch.arange(mask.shape[0], device=mask.device) * 7 % sk + 1
        mask[:] = (torch.arange(sk, device=mask.device)[None, :]
                   < lengths[:, None]).float()
    mask[1] = 0.0  # a (bh) row with no valid key
    return mask


def _tma_run(device, bh, sq, sk, d, causal, case, seed):
    """The bf16 K5 and K6 once each on seeded inputs with the edge mask
    ``case``: (q, k, v, g, mask, out, lse, grads), one launch of each."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _tma_edge_mask(mask, case, sk)
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    return q, k, v, g, mask, out, lse, grads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d,fwd_src,bwd_src", [
    # The bf16 Transformer's sequence length, D = 16: both new kernels.
    ("post_padding", 132, 512, 512, 16, "tma", "tma"),
    # Ragged Sq and Sk, not multiples of 64 or 128, Sq != Sk.
    ("post_padding", 140, 200, 300, 16, "tma", "tma"),
    ("padding_tiles", 132, 300, 390, 16, "tma", "tma"),
    ("last_tile_only", 133, 130, 270, 16, "tma", "tma"),
    ("post_padding", 132, 130, 150, 32, "tma", "tma"),
    ("padding_tiles", 132, 260, 300, 32, "tma", "tma"),
    # K6 routed elsewhere: D = 64 (flash_attention_cluster_bf16.cu's
    # one-block kernels); too few (bh), Sq past the most rows an item
    # holds: K6 over query ranges (one, and seven of 128 rows).
    ("post_padding", 132, 70, 200, 64, "tma", "cluster"),
    ("last_tile_only", 6, 150, 130, 16, "tma", "tma"),
    ("post_padding", 132, 800, 130, 32, "tma", "tma"),
])
def test_tma_bf16_kernels(device, case, bh, sq, sk, d, fwd_src, bwd_src,
                            causal):
    """The bf16 K5 and K6 of flash_attention_tma_bf16.cu (or, where
    _kernel routes K6 elsewhere by width, flash_attention_cluster_bf16.cu's)
    against
    their fp64 and bf16 plain versions; the checks reject dk less its first
    query tile and dq less its first key tile. A row with no valid key
    gives out 0, lse 0 and no gradient."""
    q, k, v, g, mask, out, lse, grads = _tma_run(device, bh, sq, sk, d,
                                                   causal, case, 21)
    assert att._kernel(torch.bfloat16, d, False)[0] == (
        f"flash_attention_{fwd_src}_bf16".replace("_bf16_bf16", "_bf16"))
    assert att._kernel(torch.bfloat16, d, True)[0] == (
        f"flash_attention_{bwd_src}_bf16".replace("_bf16_bf16", "_bf16"))
    at.check_forward_bf16((out, lse), q, k, v, mask, causal)
    planted_keys = 128 if case != "last_tile_only" else 0
    checks = at.check_backward_bf16(grads, q, k, v, mask, out, lse, g,
                                    causal, planted_rows=64,
                                    planted_keys=planted_keys)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    if planted_keys:
        assert checks["dq"]["planted"]["key_tile_dropped"] > 1
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert grad.dtype == torch.bfloat16 and not grad[1].any()


@pytest.mark.parametrize("d", [16, 32])
def test_tma_bf16_kernels_are_deterministic(device, d):
    """Two calls of the bf16 K5 and the one-pass K6 give the same bits:
    each dq row adds its key tiles in ascending order, the two warpgroups'
    halves of each in a fixed turn, and no atomics."""
    for causal in (False, True):
        runs = [_tma_run(device, 140, 300, 260, d, causal, "post_padding",
                           22)[5:] for _ in range(2)]
        assert att._kernel(torch.bfloat16, d, True)[0] == (
            "flash_attention_tma_bf16")
        (out_a, lse_a, grads_a), (out_b, lse_b, grads_b) = runs
        assert torch.equal(out_a, out_b) and torch.equal(lse_a, lse_b)
        for a, b in zip(grads_a, grads_b):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [16, 32])
def test_tma_bf16_backward_at_its_longest_query_side(device, d):
    """The one-pass K6 holds dq, lse and delta of an item's query rows in
    shared memory: the C function's limit is att.TMA_BWD_MAX_ROWS[d]; at
    BH = 132 the kernel takes Sq up to it in one range and passes its
    check there, and one row more in two ranges (no other source)."""
    from deep_recommenders_torch.ops import _build
    import ctypes

    limit = _build.function("flash_attention_tma_bf16",
                            "flash_attention_tma_bwd_max_rows_bf16",
                            [ctypes.c_int32])
    sq = att.TMA_BWD_MAX_ROWS[d]
    assert limit(d) == sq and limit(64) == 0
    sms = att._sm_count(device)
    for rows in (sq, sq + 1):
        assert att._kernel(torch.bfloat16, d, True)[0] == (
            "flash_attention_tma_bf16")
        plan = att.bwd_query_ranges(132, rows, 140, d, sms, True)
        assert len(plan) - 1 == (1 if rows == sq else 2)
        before = dict(att.flash_attention.launches_by_source)
        q, k, v, g, mask, out, lse, grads = _tma_run(
            device, 132, rows, 140, d, True, "post_padding", 23)
        ranged = att.flash_attention.launches_by_source.get(
            "flash_attention_tma_bf16.bwd.ranges", 0) - before.get(
            "flash_attention_tma_bf16.bwd.ranges", 0)
        assert ranged == (rows > sq)
        at.check_backward_bf16(grads, q, k, v, mask, out, lse, g, True)


# The bf16 K6 of flash_attention_tma_bf16.cu over query ranges: (BH, Sq, Sk,
# D, the edge mask, the ranges' starts in query tiles: None for
# bwd_query_ranges' plan, or a plan forced on the wrapper). BH = 1 at
# Sq = 4096 (32 ranges of one tile, causal 19 of equal work); BH = 131
# past D = 32's most rows (two ranges); few (bh) just past D = 16's most
# rows; forced plans of two ranges of 9 tiles, of 17 tiles and one, of six
# tiles at D = 32 with a shorter last, and of ranges of 1-17 tiles; Sk !=
# Sq and not multiples of 128.
_RANGE_CASES = [
    (1, 4096, 4096, 16, None, None),
    (131, 769, 300, 32, "post_padding", None),
    (4, 2177, 2177, 16, "padding_tiles", None),
    (4, 2177, 2177, 16, "last_tile_only", (0, 9, 18)),
    (4, 2177, 1000, 16, "post_padding", (0, 17, 18)),
    (4, 4096, 4096, 32, "post_padding", (0, 6, 12, 18, 24, 30, 32)),
    (4, 4096, 3000, 16, "padding_tiles", (0, 1, 17, 20, 32)),
    (6, 769, 769, 32, "last_tile_only", None),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d,case,rows", _RANGE_CASES)
def test_tma_bf16_backward_over_query_ranges(device, monkeypatch, bh, sq, sk,
                                             d, case, rows, causal):
    """The bf16 K6 over query ranges against fp64 and its bf16 plain version
    (check_backward_bf16, on every (bh) row), with dk less its first
    query tile and dq less its first key tile rejected; two calls give the
    same bits; the wrapper counts one launch, and one call over more than
    one range; a row with no valid key gives no gradient; and the kernel
    with one range's dk and dv partials left out of the sum
    (flash_attention_backward_lost_range: the first, and the one of the
    most query rows) fails the check."""
    if rows is not None:
        monkeypatch.setattr(att, "bwd_query_ranges",
                            lambda *args: rows)
    plan = att.bwd_query_ranges(bh, sq, sk, d, att._sm_count(device),
                                causal)
    ranges = len(plan) - 1
    assert ranges > 1 or (causal and rows is None)
    gen = torch.Generator(device=device).manual_seed(31)
    if case is None:
        q, k, v = (_normal(gen, bh, s, d) for s in (sq, sk, sk))
        mask = (torch.rand(bh, sk, device=device, generator=gen)
                < 0.7).float()
    else:
        q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
        mask = _tma_edge_mask(mask, case, sk)
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    before = dict(att.flash_attention.launches)
    by_source = dict(att.flash_attention.launches_by_source)
    runs = [att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "bwd_bf16": before["bwd_bf16"] + 2}
    for key, calls in (("flash_attention_tma_bf16.bwd", 2),
                       ("flash_attention_tma_bf16.bwd.ranges",
                        2 if ranges > 1 else 0)):
        assert att.flash_attention.launches_by_source.get(key, 0) == \
            by_source.get(key, 0) + calls
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    grads = runs[0]
    args = (q, k, v, mask, out, lse, g, causal)
    planted_keys = 128 if case not in ("last_tile_only",) and sk > 128 else 0
    checks = at.check_backward_bf16(grads, *args,
                                    planted_rows=64,
                                    planted_keys=planted_keys)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    if planted_keys:
        assert checks["dq"]["planted"]["key_tile_dropped"] > 1
    if bh > 1 and case is not None:
        for grad in grads:
            assert grad.dtype == torch.bfloat16 and not grad[1].any()
    # The first range, and the one of the most query rows (a range of
    # fewer than 64 rows may lose less than the checks resolve).
    rows_of = [min(sq, plan[r + 1] * 128) - plan[r] * 128
               for r in range(ranges)]
    widest = max(range(ranges), key=lambda r: (rows_of[r], r))
    for drop in sorted({0, widest} if ranges > 1 else ()):
        lost = att.flash_attention_backward_lost_range(
            q, k, v, mask, out, lse, g, causal, drop)
        assert torch.equal(lost[0], grads[0])  # dq is whole
        shares = at.check_backward_bf16(lost, *args, hold=False)
        assert max(shares[n]["err_over_tol"] for n in ("dk", "dv")) > 1


# The bf16 K6 over query ranges in groups, a launch each: (BH, Sq, Sk, D,
# the plan's query tiles a range, the ranges a group): 258 ranges of one
# tile, past the kernel's table of 256 (in groups of 256 and of 7), and 32
# of one tile at D = 32 in groups of 1, 5 and 32; post-padding rows
# (_tma_edge_mask), (bh) row 1 with no valid key.
_GROUP_CASES = [
    (4, 33000, 300, 16, 1, (256, 7)),
    (4, 4096, 700, 32, 1, (32, 5, 1)),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d,tiles,groups", _GROUP_CASES)
def test_tma_bf16_backward_in_groups_of_ranges(device, monkeypatch, bh, sq,
                                               sk, d, tiles, groups,
                                               causal):
    """Ranges run in groups of what TMA_BWD_PART_BYTES holds, the groups'
    sums folded in range order through an fp32 accumulator: every grouping
    gives the same bits, which pass the bf16 checks against fp64 and the
    plain version; where a range holds a 32nd of the query rows or more,
    the last range lost, in the last group of the finest grouping
    (flash_attention_backward_lost_range), is rejected (a 258th is below
    the checks' resolution)."""
    nq = -(-sq // 128)
    plan = tuple(range(0, nq, tiles)) + (nq,)
    ranges = len(plan) - 1
    monkeypatch.setattr(att, "bwd_query_ranges", lambda *args: plan)
    gen = torch.Generator(device=device).manual_seed(41)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _tma_edge_mask(mask, "post_padding", sk)
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    per_range = 2 * bh * sk * d * 4
    runs = []
    for group in groups:
        monkeypatch.setattr(att, "TMA_BWD_PART_BYTES", group * per_range)
        assert att.bwd_range_group(bh, sk, d, ranges) == group
        runs.append(att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                                 causal))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    at.check_backward_bf16(runs[0], q, k, v, mask, out, lse, g, causal)
    for grad in runs[0]:
        assert not grad[1].any()
    if ranges > 32:
        return
    lost = att.flash_attention_backward_lost_range(
        q, k, v, mask, out, lse, g, causal, ranges - 1)
    assert torch.equal(lost[0], runs[0][0])
    shares = at.check_backward_bf16(lost, q, k, v, mask, out, lse, g, causal,
                                    hold=False)
    assert max(shares[n]["err_over_tol"] for n in ("dk", "dv")) > 1


def test_flash_attention_bf16_autograd_and_dispatch(device):
    """bf16 operands through FlashAttention and attention(): the bf16
    kernels, gradients in bf16, the same out as the direct call."""
    gen = torch.Generator(device=device).manual_seed(8)
    q, k, v, mask = _attention_inputs(gen, 16, 200, 200, 16)
    q, k, v, g = _bf16(q, k, v, _normal(gen, 16, 200, 16))
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, mask, True)
    out.backward(g)
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    again, lse = att.flash_attention(q, k, v, mask, True, return_lse=True)
    assert out.dtype == torch.bfloat16 and torch.equal(again, out.detach())
    assert all(a.grad.dtype == torch.bfloat16 for a in args)
    at.check_backward_bf16([a.grad for a in args], q, k, v, mask, again, lse,
                           g, True)
    big = _normal(gen, 2048, 512, 16).to(torch.bfloat16).requires_grad_()
    before = dict(att.flash_attention.launches)
    att.attention(big, big, big, causal=True).float().sum().backward()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}


def test_flash_attention_bf16_rejects_other_dtypes(device):
    q = torch.zeros(2, 8, 16, device=device, dtype=torch.bfloat16)
    mask = torch.ones(2, 8, device=device)
    with pytest.raises(TypeError):  # fp16 has no kernel
        h = q.half()
        att.flash_attention(h, h, h, mask)
    with pytest.raises(TypeError):  # operands of two dtypes
        att.flash_attention(q, q.float(), q, mask)
    out, lse = att.flash_attention(q, q, q, mask, return_lse=True)
    with pytest.raises(TypeError):  # lse stays fp32
        att.flash_attention_backward(q, q, q, mask, out, lse.bfloat16(), q)
    with pytest.raises(TypeError):  # g in q's dtype
        att.flash_attention_backward(q, q, q, mask, out, lse, q.float())
    with pytest.raises(ValueError):  # the kernels copy 16-byte pieces
        shifted = torch.zeros(2 * 8 * 16 + 1, device=device,
                              dtype=torch.bfloat16)[1:].view(2, 8, 16)
        att.flash_attention(shifted, q, q, mask)


# -- head widths without a kernel of their own ------------------------------

def _padded_lse(q, k, v, mask, causal):
    """The lse of K5 on q, k, v padded to the next kernel width, as
    FlashAttention runs it (deterministic: the one its backward used)."""
    d = q.shape[-1]
    width = att.kernel_head_dim(d)
    qp, kp, vp = (att.pad_head_dim(t, width) for t in (q, k, v))
    return att.flash_attention(qp, kp, vp, mask, causal, return_lse=True,
                               scale=d ** -0.5)[1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 48, 96, 200, 257])
def test_flash_attention_pads_head_widths(device, d, dtype, causal):
    """FlashAttention at head widths without a kernel: q, k, v and g go to
    K5 and K6 padded with zero columns to the next kernel width at scale
    D ** -0.5 (one launch each of the dtype's kernels), and out, dq, dk, dv
    come back at D and pass the checks of ops/attention_tolerances.py at
    the true D against the plain versions."""
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v, mask = _attention_inputs(gen, 6, 150, 130, d)
    g = _normal(gen, 6, 150, d)
    if dtype == torch.bfloat16:
        q, k, v, g = _bf16(q, k, v, g)
    fwd, bwd = (("fwd_bf16", "bwd_bf16") if dtype == torch.bfloat16
                else ("fwd", "bwd"))
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, mask, causal)
    out.backward(g)
    assert att.flash_attention.launches == {
        **before, fwd: before[fwd] + 1, bwd: before[bwd] + 1}
    out = out.detach()
    grads = [a.grad for a in args]
    assert out.shape == q.shape and out.dtype == dtype
    lse = _padded_lse(q, k, v, mask, causal)
    if dtype == torch.bfloat16:
        at.check_forward_bf16((out, lse), q, k, v, mask, causal)
        at.check_backward_bf16(grads, q, k, v, mask, out, lse, g, causal)
    else:
        at.check_forward((out, lse), q, k, v, mask, causal)
        at.check_backward(grads, q, k, v, mask, out, lse, g, causal)
    assert not out[1].any()
    for grad in grads:
        assert grad.dtype == dtype and not grad[1].any()


def test_attention_dispatch_pads_or_goes_dense_by_head_width(device):
    """attention() over the memory budget: at D = 8 (the IMDB example's
    --model-dim 32 --max-len 1024, BH 256) it goes through K5 and K6 and
    agrees with the plain versions on 32 of its rows; at D = 200 and
    D = 257 it goes through the D = 256 and D = 320 kernels, padded, with
    no warning, and agrees with the plain versions on 4 rows."""
    gen = torch.Generator(device=device).manual_seed(12)
    q, k, v, mask = _attention_inputs(gen, 256, 1024, 1024, 8)
    g = _normal(gen, 256, 1024, 8)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.attention(*args, key_mask=mask)
    out.backward(g)
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    rows = slice(0, 32)
    lse = _padded_lse(q[rows], k[rows], v[rows], mask[rows], False)
    at.check_forward((out.detach()[rows], lse), q[rows], k[rows], v[rows],
                     mask[rows], False)
    at.check_backward([a.grad[rows] for a in args], q[rows], k[rows],
                      v[rows], mask[rows], out.detach()[rows], lse, g[rows],
                      False)
    # D = 200 over the budget: the D = 256 kernels, padded, no warning.
    mid = _normal(gen, 160, 1024, 200)
    before = dict(att.flash_attention.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = att.attention(mid, mid, mid, key_mask=mask[:160])
    assert att.flash_attention.launches == {**before,
                                            "fwd": before["fwd"] + 1}
    lse = _padded_lse(mid[:4], mid[:4], mid[:4], mask[:4], False)
    at.check_forward((got[:4], lse), mid[:4], mid[:4], mid[:4], mask[:4],
                     False)
    wide = _normal(gen, 160, 1024, 257)
    before = dict(att.flash_attention.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = att.attention(wide, wide, wide, key_mask=mask[:160])
    assert att.flash_attention.launches == {**before,
                                            "fwd": before["fwd"] + 1}
    lse = _padded_lse(wide[:4], wide[:4], wide[:4], mask[:4], False)
    at.check_forward((got[:4], lse), wide[:4], wide[:4], wide[:4], mask[:4],
                     False)


# -- the forward kernels as ops (ops/custom_ops.py) ------------------------------

def _op_cases(device):
    """(op name, its arguments, the wrapper's eager call) at small shapes:
    K3 with and without residuals, K4, K5 in fp32 and bf16."""
    gen = torch.Generator(device=device).manual_seed(12)
    x0 = _normal(gen, 1024, 6)
    x0b = x0.to(torch.bfloat16)
    w1, w2 = _normal(gen, 6, 6, 32) * 0.1, _normal(gen, 6, 32, 16) * 0.1
    xv, w = _normal(gen, 1024, 8), _normal(gen, 6, 8, 16) * 0.1
    q, k, v, mask = _attention_inputs(gen, 8, 96, 80, 32)
    qb, kb, vb = _bf16(q, k, v)
    return [
        ("cin_stack_fwd", (x0b, w1, w2, 16),
         lambda: ck.stack_forward(x0b, w1, w2, 16)),
        ("cin_stack_fwd_pooled", (x0b, w1, w2, 16),
         lambda: ck.stack_forward(x0b, w1, w2, 16, residuals=False)[:2]),
        ("cin2d_fwd", (x0, xv, w), lambda: ck.cin2d_forward(x0, xv, w)),
        ("flash_attention_fwd", (q, k, v, mask, True, None),
         lambda: att.flash_attention(q, k, v, mask, True, return_lse=True)),
        ("flash_attention_fwd_bf16", (qb, kb, vb, mask, False, 0.3),
         lambda: att.flash_attention(qb, kb, vb, mask, False,
                                     return_lse=True, scale=0.3)),
    ]


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def test_kernel_ops_run_the_kernels_and_their_fakes_match(device):
    """Each op's CUDA implementation launches its kernel once and equals
    the wrapper's eager result (the same kernel on the same inputs: within
    rtol 1e-6); its fake implementation gives the real outputs' shapes,
    dtypes and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deep_recommenders_torch.ops import custom_ops
    for name, args, eager in _op_cases(device):
        op = getattr(getattr(torch.ops, custom_ops.NAMESPACE), name)
        launches = (dict(ck.cin_stack_pooled.launches),
                    dict(ck.cin2d.launches), dict(att.flash_attention.launches))
        real = _as_list(op(*args))
        torch.cuda.synchronize()
        after = (ck.cin_stack_pooled.launches, ck.cin2d.launches,
                 att.flash_attention.launches)
        moved = [(i, key) for i, (b, a) in enumerate(zip(launches, after))
                 for key in a if a[key] != b[key]]
        assert len(moved) == 1, (name, moved)
        i, key = moved[0]
        assert after[i][key] == launches[i][key] + 1
        want = [t for t in _as_list(eager()) if t is not None]
        assert len(real) == len(want)
        for got, ref in zip(real, want):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        with FakeTensorMode() as mode:
            fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args]
            fakes = _as_list(op(*fake_args))
        assert [(t.shape, t.dtype, t.device) for t in fakes] == [
            (t.shape, t.dtype, t.device) for t in real], name


def test_kernel_ops_are_captured_in_a_cuda_graph(device):
    """The op dispatch stays capturable: the wrappers recorded in a CUDA
    graph and replayed give the eager results bit for bit."""
    for name, _, eager in _op_cases(device):
        want = [t.clone() for t in _as_list(eager()) if t is not None]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = [t for t in _as_list(eager()) if t is not None]
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(out, want):
            assert torch.equal(got, ref), name


def test_served_xdeepfm_programs_launch_their_kernels(device, tmp_path):
    """An exported xDeepFM on the card: the program holds K3's (two relu
    layers) or K4's (three layers) op, serves two batch sizes, launches
    one K3 or three K4 a batch, and equals the eager model bit for bit."""
    from deep_recommenders_torch.features.columns import Feature
    from deep_recommenders_torch.models.ranking import XDeepFM
    from deep_recommenders_torch.ops import custom_ops
    from deep_recommenders_torch.serving import (
        export_model,
        load_serving_module,
    )
    specs = (Feature("a", hash_buckets=50), Feature("b", hash_buckets=40),
             Feature("c", vocab=tuple(range(8)), max_len=3))
    rng = np.random.default_rng(3)

    def batch(b):
        ids = {"a": rng.integers(0, 50, b), "b": rng.integers(0, 40, b),
               "c": rng.integers(0, 8, (b, 3))}
        out = {k: torch.from_numpy(v.astype(np.int32)).to(device)
               for k, v in ids.items()}
        return dict(out, c__wt=torch.ones(b, 3, device=device))

    for maps, op, counter, per_batch in (
            ((32, 32), "cin_stack_fwd_pooled", ck.cin_stack_pooled, 1),
            ((32, 32, 32), "cin2d_fwd", ck.cin2d, 3)):
        model = XDeepFM(specs, 8, maps, hidden=(16,),
                        generator=torch.Generator().manual_seed(0)).to(device)
        path = export_model(str(tmp_path / op), model, batch(64))
        served = load_serving_module(path, device=device)
        assert custom_ops.graph_ops(served.program.graph_module) == {op}
        for b in (64, 200):
            x = batch(b)
            before = counter.launches["fwd"]
            got = served(x)
            assert counter.launches["fwd"] == before + per_batch
            with torch.no_grad():
                assert torch.equal(got, model.eval()(x))


def test_transformer_export_on_the_card(device, tmp_path):
    """On the card the attention dispatch reads the batch size: a
    polymorphic export raises ValueError; with use_flash=True the program
    holds K5's op and launches it three times a batch (encoder self,
    decoder self and cross), equal to the eager model bit for bit."""
    from deep_recommenders_torch.models.nlp import Transformer
    from deep_recommenders_torch.ops import custom_ops
    from deep_recommenders_torch.serving import (
        export_model,
        load_serving_module,
    )

    class Seq2Seq(torch.nn.Module):
        def __init__(self, t):
            super().__init__()
            self.t = t

        def forward(self, batch):
            return self.t(batch["inputs"], batch["targets"])

    model = Seq2Seq(Transformer(30, 32, 2, 1, 1, 64, dropout=0.0)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)

    def tokens(b):
        return {n: torch.randint(1, 30, (b, s), generator=gen, device=device)
                for n, s in (("inputs", 40), ("targets", 24))}

    with pytest.raises(ValueError, match="polymorphic_batch=False"):
        export_model(str(tmp_path / "p"), model, tokens(4))
    for m in model.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = True
    served = load_serving_module(
        export_model(str(tmp_path / "f"), model, tokens(4)), device=device)
    assert custom_ops.graph_ops(served.program.graph_module) == {
        "flash_attention_fwd"}
    for b in (4, 9):
        x = tokens(b)
        before = att.flash_attention.launches["fwd"]
        got = served(x)
        assert att.flash_attention.launches["fwd"] == before + 3
        with torch.no_grad():
            assert torch.equal(got, model.eval()(x))


# -- above 2048: the bf16 K5 on clusters of 9-16 blocks; K1's large tables ----

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d", [
    ("ragged_sk", 3, 70, 67, 2112),  # 9 blocks, the last one chunk of D
    ("last_tile_only", 4, 100, 140, 2304),  # 9 blocks of 4 chunks
    ("padding_tiles", 4, 130, 260, 2304),
    ("ragged_sk", 2, 33, 61, 4096),  # 16 blocks
    ("last_tile_only", 4, 100, 140, 4096),
])
def test_cluster_bf16_forward_above_2048(device, case, bh, sq, sk, d,
                                         causal):
    """The bf16 K5 from 2048 to 4096 (flash_attention_cluster_bf16.cu:
    clusters of ceil(D / 256) blocks, a non-portable size, that
    reduce-scatter their partial scores): routed there, one launch a call,
    against its fp64 and bf16 plain versions with the fault of a lost
    partial (the last block's) rejected, rows with no valid key giving
    out 0 and lse 0, and two calls bit for bit."""
    _check_reduce_scatter_forward(device, case, bh, sq, sk, d, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,bh,sq,sk,d", [
    ("ragged_sk", 3, 70, 67, 640),  # 3 blocks of 4 chunks, 2 past D
    ("last_tile_only", 4, 100, 140, 1024),  # 4 blocks
    ("padding_tiles", 4, 130, 260, 1536),  # 6 blocks
    ("last_tile_only", 4, 100, 140, 2048),  # 8 blocks
])
def test_cluster_bf16_forward_reduce_scatter_up_to_2048(device, case, bh, sq,
                                                        sk, d, causal):
    """The same for the portable clusters of 3-8 blocks, which
    reduce-scatter as the larger ones do."""
    _check_reduce_scatter_forward(device, case, bh, sq, sk, d, causal)


def _check_reduce_scatter_forward(device, case, bh, sq, sk, d, causal):
    assert att._kernel(torch.bfloat16, d, False)[0] == \
        "flash_attention_cluster_bf16"
    gen = torch.Generator(device=device).manual_seed(d + sq)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask = _edge_mask(mask, case, sk)
    q, k, v = _bf16(q, k, v)
    before = dict(att.flash_attention.launches)
    runs = [att.flash_attention(q, k, v, mask, causal, return_lse=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 2}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    checks = at.check_forward_bf16(runs[0], q, k, v, mask, causal,
                                   planted_partial=True)
    assert checks["planted"]["partial_dropped"] > 1
    out, lse = runs[0]
    assert not out[1].any() and not lse[1].any()


def _large_ids(rng, n, v, kind):
    if kind == "out_of_range":  # [-V, 0) wraps, the rest drop
        return torch.from_numpy(rng.integers(-2 * v, 2 * v, n).astype(
            np.int32))
    if kind == "last_row_at_2047":
        # Row V - 1 at the last place of a full segment of 2048, directly
        # and as -1: the largest key the table can give, row << 11 | 2047.
        ids = torch.from_numpy(rng.integers(0, v, n).astype(np.int32))
        ids[2047], ids[4095] = v - 1, -1
        return ids
    return _k1_bf16_ids(rng, n, v, kind)


@pytest.mark.parametrize("n,c,v,kind", [
    (16384, 17, 1_000_000, "uniform"),   # DeepFM's batch: one round
    (16384, 17, 1_000_000, "skewed"),    # 16 hot rows
    (131072, 17, 1_000_000, "batch"),    # eight rounds: a hot row in each
    (40001, 17, 4_000_000, "out_of_range"),  # 64-bit sort keys, ragged
    (16384, 17, 4_000_000, "uniform"),
    (5001, 40, 1_000_000, "batch"),      # segments of 512
    (0, 17, 1_000_000, "uniform"),       # no ids: every row +0.0
    (6000, 17, 2**21 - 1, "last_row_at_2047"),  # 32-bit keys, the largest
    (6000, 17, 2**21, "last_row_at_2047"),  # 64-bit: ~0 would be this key
    (6000, 17, 2**21 + 1, "last_row_at_2047"),
])
def test_scatter_add_rows_bf16_large_table(device, n, c, v, kind):
    """K1's large-table plan on bf16 g (segment_runs, then row_ranges):
    routed there, bit for bit ``scatter_add_rows_in_segments(g.float(),
    ids, V).to(bf16)`` run on the CPU over two calls, each counted in
    ``launches_bf16`` and ``launches_bf16_large``, the output written
    whole over memory first filled with NaN."""
    assert n == 0 or ek.large_table_plan(n, c, v)
    rng = np.random.default_rng(n + c + v)
    ids = _large_ids(rng, n, v, kind)
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(torch.bfloat16)
    want = ek.scatter_add_rows_in_segments(g.float(), ids, v).to(
        torch.bfloat16).view(torch.int16)
    if kind == "last_row_at_2047":
        assert want[v - 1].any()
    g_card, ids_card = g.to(device), ids.to(device)
    before = (ek.scatter_add_rows.launches_bf16,
              ek.scatter_add_rows.launches_bf16_large)
    for _ in range(2):
        garbage = torch.full((v, c), float("nan"), dtype=torch.bfloat16,
                             device=device)
        del garbage
        got = ek.scatter_add_rows(g_card, ids_card, v)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == (v, c)
        assert torch.equal(got.cpu().view(torch.int16), want)
    large = 2 if ek.large_table_plan(n, c, v) else 0
    assert (ek.scatter_add_rows.launches_bf16,
            ek.scatter_add_rows.launches_bf16_large) == (
        before[0] + 2, before[1] + large)


def test_scatter_add_rows_bf16_large_table_at_an_odd_address(device):
    """The large-table plan on bf16 rows of 34 bytes from a base 2 bytes
    past a 4-byte boundary, into 10^6 rows over NaN-filled memory: bit for
    bit as above."""
    rng = np.random.default_rng(6)
    n, c, v = 20001, 17, 1_000_000
    ids = _k1_bf16_ids(rng, n, v, "skewed")
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(torch.bfloat16)
    want = ek.scatter_add_rows_in_segments(g.float(), ids, v).to(
        torch.bfloat16)
    base = torch.zeros(n * c + 1, dtype=torch.bfloat16, device=device)
    base[1:] = g.reshape(-1).to(device)
    g_card = base[1:].view(n, c)
    assert g_card.data_ptr() % 4 == 2 and ek.large_table_plan(n, c, v)
    garbage = torch.full((v, c), float("nan"), dtype=torch.bfloat16,
                         device=device)
    del garbage
    before = ek.scatter_add_rows.launches_bf16_large
    got = ek.scatter_add_rows(g_card, ids.to(device), v)
    torch.cuda.synchronize()
    assert ek.scatter_add_rows.launches_bf16_large == before + 1
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
