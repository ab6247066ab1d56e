"""Times the bf16 K6 at D = 16 and 32 on long query sides and few (bh) rows,
on one card, beside the mma.sync kernels of csrc/flash_attention_bf16.cu
and cuDNN's backward.

At each (BH, Sq = Sk, D) of ``SHAPES``, non-causal and causal: q, k, v, g
seeded normals in bf16, and the key masks of SyntheticImdb rows of length
Sq repeated over the heads of an example (TX_DIM / D of them):
``chip_smoke.long_attention_inputs``.
K5 runs once through the wrapper for out and lse. Device ms from CUDA-graph
replays (``chip_smoke.graph_ms``) in the order mma.sync, routed, routed,
mma.sync ("P C C P": ``mma_sync_ms`` and ``ms`` are lists in call order),
where "routed" is ``ops.attention.flash_attention_backward`` (the kernels
``_kernel`` picks) and "mma.sync" the dq and dk/dv kernels of
csrc/flash_attention_bf16.cu called through their C function. Beside them:
the kernels one routed call runs (``kernel_split``), its query-range plan
where the tree has one, cuDNN's time (``chip_smoke.library_fields``), the
bytes bound and the tensor-core bound (``bound_ms``, as
``chip_smoke.bf16_yardsticks`` counts them), the one-pass exp floor (valid
pairs over 16 exponentials a clock on each SM at the largest SM clock) and
the floor of every lane of the scored 64-key tiles; whether two routed
calls give the same bits, the largest difference from the mma.sync
kernels', and the bf16 checks' largest share on the first two (bh) rows
(``ops.attention_tolerances.check_backward_bf16``, not held).

With ``--part-cost``: the price of a query range's fp32 partials, in the
planner's unit (``ops.attention.bwd_plan_time``: (query tile, key tile)
pairs for each key tile a range visits), at each of ``PART_COST_SHAPES``:
one range against two of half its query tiles on twice the items (every
key valid, non-causal, CUDA-graph ms in the order one, two, two, one), so
that the blocks score the same pairs and the difference is the partials'
writes and the second kernel; the price is that difference over the
model's time of a pair (the one range's ms over its pairs) and over the
partials' key tiles on the busiest block.

With ``--alternative``: the bf16 K6 at D = 64 (``dq_solo`` and ``dkv_solo`` of
csrc/flash_attention_cluster_bf16.cu, which score each pair twice, the
design the narrow widths could take instead) at ``ALTERNATIVE_SHAPES``, the
same exponentials as D = 16 and 32 at the same (BH, S) with four or two
times their products: ms and the kernels one call runs.

With ``--plans``: at each of ``PLAN_SHAPES`` (or the shapes named), non-causal
and causal, on ``measure``'s inputs, the routed K6 under every plan the
planner weighs (``ops.attention.bwd_query_ranges``: ranges of n query tiles,
the last shorter, n from 1 to the most an item holds), each timed twice in
the order n = 1 ... N, N ... 1, beside the model's time of each
(``ops.attention.bwd_plan_time``, in pairs), the planner's pick, the
fastest plan and the pick's time over the fastest's.

Prints the card's name and power limit, then one JSON line, also written
to ``build/long_bwd_times.json``.

    python3 tools/long_bwd_times.py [--part-cost] [--alternative]
        [--plans] [BH,SQ,D ...]

(``SHAPES`` when no shape and no section is named; with ``--plans`` the
shapes named are those of the plans, not timed otherwise.)
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from deep_recommenders_torch.ops import _build  # noqa: E402
from deep_recommenders_torch.ops import attention as att  # noqa: E402
from deep_recommenders_torch.ops import attention_tolerances as at  # noqa
from deep_recommenders_torch.ops import cin_tolerances as ct  # noqa: E402

# (BH, Sq = Sk, D): the zoo Transformer at batch 8 and S = 4096 (BH 64);
# Sq past one item's shared memory alone (BH 256); BH under the card's SMs
# alone (2048 and 512 query rows); and D = 32; then each side of the edges
# of one query range (chip_smoke.LONG_EDGES).
SHAPES = ((64, 4096, 16), (256, 4096, 16), (128, 2048, 16), (64, 512, 16),
          (256, 1024, 32), (64, 4096, 32), *cs.LONG_EDGES)
CHECK_ROWS = 2
# (BH, Sq, Sk, D, one range, two ranges): 132 items of 16 query tiles
# against 264 of 8 at D = 16; of 6 against 3 at D = 16 and 32 (the most
# rows an item holds at 32), over 16 key tiles.
PART_COST_SHAPES = ((132, 2048, 2048, 16, (0, 16), (0, 8, 16)),
                    (132, 768, 2048, 16, (0, 6), (0, 3, 6)),
                    (132, 768, 2048, 32, (0, 6), (0, 3, 6)))
# (BH, S): the long path's and the D = 32 edge's.
ALTERNATIVE_SHAPES = ((64, 4096), (132, 769))
# The timed shapes that the planner cuts into more than one range, or may.
PLAN_SHAPES = ((64, 4096, 16), (256, 4096, 16), (64, 512, 16),
               (256, 1024, 32), (64, 4096, 32), (132, 2177, 16),
               (132, 769, 32))


def measure(bh: int, s: int, d: int, causal: bool, device,
            exp_rate: float) -> dict:
    q, k, v, g, mask, heads = cs.long_attention_inputs(bh, s, d, device)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)

    def routed():
        return att.flash_attention_backward(q, k, v, mask, out, lse, g,
                                            causal)

    _, sync = cs.mma_sync_bf16_calls(q, k, v, g, mask, causal)
    times = {"mma_sync": [], "routed": []}
    for name in ("mma_sync", "routed", "routed", "mma_sync"):
        times[name].append(cs.graph_ms(sync if name == "mma_sync"
                                       else routed, 5, 4))
    first, second, old = routed(), routed(), sync()
    torch.cuda.synchronize()
    bits = all(torch.equal(a, b) for a, b in zip(first, second))
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(first, old))
    rows = slice(0, CHECK_ROWS)
    checks = at.check_backward_bf16(
        [t[rows] for t in first], q[rows], k[rows], v[rows], mask[rows],
        out[rows], lse[rows], g[rows], causal, hold=False)
    pairs = cs._valid_pairs(mask, causal)
    lanes = cs.live_tile_pairs(mask, causal)
    num_bytes = (8 * bh * s * d) * 2 + 2 * bh * s * 4
    bound_ms, bound_by = cs.bound(num_bytes, pairs * 10 * d,
                                  cs.BF16_OPS_PER_S)
    plan = getattr(att, "bwd_query_ranges", None)
    fields = {
        "route": att._kernel(torch.bfloat16, d, True)[0],
        "range_starts": (plan(bh, s, s, d, att._sm_count(device), causal)
                         if plan else None),
        "ms": times["routed"], "mma_sync_ms": times["mma_sync"],
        "kernel_split": cs.kernel_times(routed, top=3),
        "bytes_ms": num_bytes / cs.HBM_BYTES_PER_S * 1e3,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "exp_floor_one_pass_ms": pairs / exp_rate * 1e3,
        "exp_floor_lanes_ms": lanes / exp_rate * 1e3,
        "scored_pairs": pairs, "valid_keys": mask.mean().item(),
        "two_calls_bit_equal": bits,
        "max_abs_diff_mma_sync": diff,
        "check_rows_worst_share": ct.worst_share(checks),
    }
    del first, second, old
    # The library takes (B, H, S, D) with a mask a row of B: one head an
    # example where the heads do not divide BH (each (bh) row its own mask).
    lib = cs.library_fields(q, k, v, mask, causal, g,
                            heads if bh % heads == 0 else 1)
    fields["library_ms"] = lib["library_ms"]
    fields["library"] = lib.get("library_kernels", lib.get("library"))
    del q, k, v, g, mask, out, lse
    torch.cuda.empty_cache()
    return fields


def part_cost(device) -> dict:
    """The partials' price at each of PART_COST_SHAPES (module docstring)."""
    result = {}
    planner, sms = att.bwd_query_ranges, att._sm_count(device)
    for bh, sq, sk, d, one, two in PART_COST_SHAPES:
        gen = torch.Generator(device=device).manual_seed(cs.SEED)
        q, g = (torch.randn(bh, sq, d, device=device, generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(bh, sk, d, device=device, generator=gen)
                .to(torch.bfloat16) for _ in range(2))
        mask = torch.ones(bh, sk, device=device)
        out, lse = att.flash_attention(q, k, v, mask, False, return_lse=True)
        times = {one: [], two: []}
        try:
            for plan in (one, two, two, one):
                att.bwd_query_ranges = lambda *args, plan=plan: plan

                def call():
                    return att.flash_attention_backward(q, k, v, mask, out,
                                                        lse, g, False)

                times[plan].append(cs.graph_ms(call, 5, 4))
        finally:
            att.bwd_query_ranges = planner
        price = att.TMA_BWD_PART_PAIRS[d]
        try:
            model = {}
            for c in (0.0, 1.0):
                att.TMA_BWD_PART_PAIRS[d] = c
                model[c] = [att.bwd_plan_time(bh, sq, sk, d, sms, False,
                                              plan) for plan in (one, two)]
        finally:
            att.TMA_BWD_PART_PAIRS[d] = price
        t1, t2 = (float(np.mean(times[p])) for p in (one, two))
        pair_ms = t1 / model[0.0][0]
        tiles = model[1.0][1] - model[0.0][1]
        result[f"{bh},{sq},{sk},{d}"] = {
            "one_range": one, "two_ranges": two,
            "one_ms": times[one], "two_ms": times[two],
            "pair_ms": pair_ms, "part_key_tiles_busiest_block": tiles,
            "price_pairs_per_key_tile": (t2 / pair_ms - model[0.0][1])
            / tiles,
            "price_in_use": price}
        del q, k, v, g, mask, out, lse
        torch.cuda.empty_cache()
    return result


def alternative(device) -> dict:
    """The bf16 K6 at D = 64 at each of ALTERNATIVE_SHAPES."""
    result = {}
    for bh, s in ALTERNATIVE_SHAPES:
        q, k, v, g, mask, _ = cs.long_attention_inputs(bh, s, 64, device)
        fields = {"route": att._kernel(torch.bfloat16, 64, True)[0]}
        for causal in (False, True):
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)

            def call():
                return att.flash_attention_backward(q, k, v, mask, out, lse,
                                                    g, causal)

            fields[f"causal={causal}"] = {
                "ms": cs.graph_ms(call, 5, 4),
                "kernel_split": cs.kernel_times(call, top=3)}
        result[f"{bh},{s},64"] = fields
        del q, k, v, g, mask, out, lse
        torch.cuda.empty_cache()
    return result


def plans(shapes, device) -> dict:
    """Every candidate plan's time at each of ``shapes`` (module
    docstring)."""
    result = {}
    planner, sms = att.bwd_query_ranges, att._sm_count(device)
    for bh, s, d in shapes:
        q, k, v, g, mask, _ = cs.long_attention_inputs(bh, s, d, device)
        nq = -(-s // att.TMA_BWD_TILE)
        most = min(nq, att.TMA_BWD_MAX_ROWS[d] // att.TMA_BWD_TILE)
        cuts = [tuple(range(0, nq, n)) + (nq,) for n in range(1, most + 1)]
        fields = {}
        for causal in (False, True):
            pick = planner(bh, s, s, d, sms, causal)
            out, lse = att.flash_attention(q, k, v, mask, causal,
                                           return_lse=True)
            times = {cut: [] for cut in cuts}
            try:
                for cut in cuts + cuts[::-1]:
                    att.bwd_query_ranges = lambda *args, cut=cut: cut

                    def call():
                        return att.flash_attention_backward(
                            q, k, v, mask, out, lse, g, causal)

                    times[cut].append(cs.graph_ms(call, 5, 4))
            finally:
                att.bwd_query_ranges = planner
            mean = {cut: float(np.mean(t)) for cut, t in times.items()}
            fastest = min(cuts, key=mean.get)
            fields[f"causal={causal}"] = {
                "pick_tiles": pick[1], "fastest_tiles": fastest[1],
                "pick_over_fastest": mean[pick] / mean[fastest],
                "plans": [{"tiles": cut[1], "ranges": len(cut) - 1,
                           "ms": times[cut],
                           "model_pairs": att.bwd_plan_time(
                               bh, s, s, d, sms, causal, cut)}
                          for cut in cuts]}
            del out, lse
        result[f"{bh},{s},{d}"] = fields
        del q, k, v, g, mask
        torch.cuda.empty_cache()
    return result


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("long_bwd_times: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line())
    _build.build()
    device = torch.device("cuda")
    flags = {"--part-cost", "--alternative", "--plans"}
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv
              if a not in flags]
    result = {}
    if "--plans" in argv:
        result["plans"] = plans(shapes or PLAN_SHAPES, device)
        print(json.dumps({"plans": result["plans"]}), file=sys.stderr,
              flush=True)
        shapes = []
    elif not shapes and not flags & set(argv):
        shapes = SHAPES
    exp_rate = cs.SMS * cs.EXP_PER_SM_CLOCK * cs.sm_clock_hz()
    if "--part-cost" in argv:
        result["part_cost"] = part_cost(device)
        print(json.dumps({"part_cost": result["part_cost"]}),
              file=sys.stderr, flush=True)
    if "--alternative" in argv:
        result["alternative_d64"] = alternative(device)
        print(json.dumps({"alternative_d64": result["alternative_d64"]}),
              file=sys.stderr, flush=True)
    for bh, s, d in shapes:
        result[f"{bh},{s},{d}"] = {
            f"causal={c}": measure(bh, s, d, c, device, exp_rate)
            for c in (False, True)}
        print(json.dumps({f"{bh},{s},{d}": result[f"{bh},{s},{d}"]}),
              file=sys.stderr, flush=True)
    line = json.dumps({"long_bwd_times": result},
                      default=lambda x: float(np.float64(x)))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "long_bwd_times.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
