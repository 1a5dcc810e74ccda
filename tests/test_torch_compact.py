"""The plain versions of bwtpu_torch's compaction and read-prep kernels
(csrc/compact.cu, csrc/prep.cu) against bwtpu's jnp code, and the
compaction callers' capacity flags against the reference's cumsum form,
on seeded inputs at their edge cases. Exact equality (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bwtpu.kernels.compact as jcompact
import bwtpu.kernels.prep as jprep
from bwtpu.kernels.verify2 import pack_reads as j_pack_reads
from bwtpu_torch import engine as te
from bwtpu_torch.kernels import compact as tcompact
from bwtpu_torch.kernels import prep as tprep
from bwtpu_torch.kernels import search2 as tsearch2

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _cut(valid, cap):
    """The reference callers' capacity cut: valid & (cumsum(valid) > cap)."""
    v = jnp.asarray(valid)
    return np.asarray(v & (jnp.cumsum(v.astype(jnp.int32)) > cap))


# name: (lanes, capacity, mask of the lanes from rng)
MASKS = {
    "random": (3000, 700, lambda rng, n: rng.random(n) < 0.3),
    "empty": (3000, 64, lambda rng, n: np.zeros(n, bool)),
    "all_past_cap_1": (500, 1, lambda rng, n: np.ones(n, bool)),
    "cap_1_sparse": (3000, 1, lambda rng, n: rng.random(n) < 0.01),
    "cap_eq_lanes_full": (2048, 2048, lambda rng, n: np.ones(n, bool)),
    "cap_eq_lanes_half": (4097, 4097, lambda rng, n: rng.random(n) < 0.5),
    "cap_past_a_tile": (6000, 2049, lambda rng, n: rng.random(n) < 0.6),
    "last_lane_only": (2049, 8, lambda rng, n: np.arange(n) == n - 1),
}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_compact_plain_matches_bwtpu(case):
    """compact_plain's (sel, count, overflow) against bwtpu's compact, its
    over flag against the callers' cumsum cut; `compact` on CPU tensors is
    compact_plain."""
    n, cap, make = MASKS[case]
    valid = make(np.random.default_rng(n + cap), n)
    got = tcompact.compact_plain(_t(valid), cap)
    for name, a, b in zip(("sel", "count", "overflow"), got,
                          jcompact.compact(jnp.asarray(valid), cap), strict=False):
        _eq(a, b, name)
    _eq(got[3], _cut(valid, cap), "over")
    assert got[3].dtype == torch.bool and got[0].dtype == got[1].dtype == torch.int32
    assert int(got[3].sum()) == int(got[2]) == max(0, int(valid.sum()) - cap)
    for a, b in zip(tcompact.compact(_t(valid), cap), got, strict=True):
        _eq(a, b)


def _counts_part_way(rng, n, H):
    """Counts of 1..H whose running sum passes the capacity (returned too)
    in the middle of a lane's slots."""
    c = rng.integers(1, H + 1, size=n).astype(np.int32)
    c[n // 2] = H
    return c, int(c[: n // 2].sum()) + H // 2


# name: (lanes, H, capacity or None, counts from rng); capacity None: the
# counts maker also returns it
COUNTS = {
    "random_neg_and_past_H": (400, 8, 700, lambda rng, n, H: np.where(
        rng.random(n) < 0.5, 0, rng.integers(-3, 2 * H, size=n)).astype(np.int32)),
    "empty": (400, 8, 64, lambda rng, n, H: np.zeros(n, np.int32)),
    "all_negative": (300, 4, 16, lambda rng, n, H: -rng.integers(1, 9, size=n).astype(np.int32)),
    "every_lane_past_cap": (300, 16, 5, lambda rng, n, H: np.full(n, H, np.int32)),
    "cap_eq_lanes": (1000, 4, 1000, lambda rng, n, H: rng.integers(0, H + 1, size=n)
                     .astype(np.int32)),
    "cap_1": (500, 32, 1, lambda rng, n, H: rng.integers(0, 3, size=n).astype(np.int32)),
    "lane_cut_part_way": (600, 16, None, _counts_part_way),
    "past_a_tile": (5000, 2, 3000, lambda rng, n, H: rng.integers(-1, 4, size=n)
                    .astype(np.int32)),
}


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_compact_counts_plain_matches_bwtpu(case):
    """compact_counts_plain against bwtpu's compact_counts on every output
    (sel, count, overflow, dropped); dropped is exactly the lanes whose
    slots the capacity cut; `compact_counts` on CPU tensors is the plain
    version."""
    n, H, cap, make = COUNTS[case]
    rng = np.random.default_rng(n * H)
    counts = make(rng, n, H)
    if cap is None:
        counts, cap = counts
    got = tcompact.compact_counts_plain(_t(counts), H, cap)
    for name, a, b in zip(("sel", "count", "overflow", "dropped"), got,
                          jcompact.compact_counts(jnp.asarray(counts), H, cap), strict=True):
        _eq(a, b, name)
    c = np.clip(counts, 0, H)
    end = np.cumsum(c)
    _eq(got[3], (c > 0) & (end > cap), "dropped")
    if case == "lane_cut_part_way":
        lane = n // 2
        assert end[lane] - c[lane] < cap < end[lane] and bool(got[3][lane])
    for a, b in zip(tcompact.compact_counts(_t(counts), H, cap), got, strict=True):
        _eq(a, b)


def _packed(rng, B: int, L: int):
    """pack_reads rows of random codes with a few ambiguous bases."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    amb = (rng.random((B, L)) < 0.05).astype(np.int32)
    words, amb_bits, _ = j_pack_reads(codes, amb, np.full(B, L, np.int32))
    return words, amb_bits


@pytest.mark.parametrize("L", [16, 32, 100, 385, 400])
def test_revcomp_packed_plain_matches_bwtpu(L):
    """revcomp_packed_plain against bwtpu's revcomp_packed on packed reads
    (L a multiple of 16 or not; W = 25 at 385 and 400 bp) and on random
    words; revcomp_both_plain stacks the strands, forward rows first, with
    lens2 = L."""
    rng = np.random.default_rng(L)
    W = (L + 15) // 16
    words, amb = _packed(rng, 300, L)
    noise = rng.integers(-2**31, 2**31, size=(300, W), dtype=np.int64).astype(np.int32)
    for w in (words, noise):
        got = tprep.revcomp_packed_plain(_t(w), _t(amb), L)
        for a, b in zip(got, jprep.revcomp_packed(jnp.asarray(w), jnp.asarray(amb), L),
                        strict=True):
            _eq(a, b)
        rw2, ab2, lens2 = tprep.revcomp_both_plain(_t(w), _t(amb), L)
        _eq(rw2, np.concatenate([w, np.asarray(got[0])]))
        _eq(ab2, np.concatenate([amb, np.asarray(got[1])]))
        _eq(lens2, np.full(600, L, np.int32))
        for a, b in zip(tprep.revcomp_both(_t(w), _t(amb), L), (rw2, ab2, lens2), strict=True):
            _eq(a, b)
    # a read and its reverse complement: the complement of the complement
    rc_w, rc_a = tprep.revcomp_packed_plain(_t(words), _t(amb), L)
    back = tprep.revcomp_packed_plain(rc_w, rc_a, L)
    _eq(back[0], words)
    _eq(back[1], amb)


def _stacked_want(w, amb, L):
    """bwtpu's revcomp_packed with device_prep_packed's stacking: forward
    rows first, then the reverse complements; lens2 = L."""
    rc_w, rc_a = jprep.revcomp_packed(jnp.asarray(w), jnp.asarray(amb), L)
    return (np.concatenate([w, np.asarray(rc_w)]), np.concatenate([amb, np.asarray(rc_a)]),
            np.full(2 * len(w), L, np.int32))


def _in_place(w, amb):
    """The engine's upload: stacked int32[2B, W] planes with the reads in
    rows [0, B) (rows [B, 2B) garbage), and those rows as the inputs."""
    B, W = w.shape
    planes = [torch.full((2 * B, W), -7, dtype=torch.int32) for _ in range(2)]
    planes[0][:B] = _t(w)
    planes[1][:B] = _t(amb)
    return planes[0][:B], planes[1][:B], tuple(planes)


@pytest.mark.parametrize("B", [0, 300])
@pytest.mark.parametrize("L", [17, 32, 33, 100, 128, 129, 400])
def test_revcomp_both_in_place_matches_plain_and_bwtpu(L, B):
    """The engine's call of revcomp_both (words and amb are rows [0, B) of
    the stacked planes; only rows [B, 2B) and lens2 are written, into those
    planes) equal to revcomp_both_plain and to bwtpu's revcomp_packed +
    device_prep_packed's stacking: packed reads with every seventh read
    all-ambiguous, and random words; so is the forward call into given
    planes, and device_prep_packed's in-place call."""
    rng = np.random.default_rng(L + B)
    W = (L + 15) // 16
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    amb = (rng.random((B, L)) < 0.05).astype(np.int32)
    amb[::7] = 1
    words, amb_bits, _ = j_pack_reads(codes, amb, np.full(B, L, np.int32))
    noise = rng.integers(-2**31, 2**31, size=(B, W), dtype=np.int64).astype(np.int32)
    for w in (words, noise):
        w = np.asarray(w).reshape(B, W)
        a = np.asarray(amb_bits).reshape(B, W)
        want = _stacked_want(w, a, L) if B else (w, a, np.zeros(0, np.int32))
        plain = tprep.revcomp_both_plain(_t(w), _t(a), L)
        words_v, amb_v, planes = _in_place(w, a)
        got = tprep.revcomp_both(words_v, amb_v, L, planes)
        assert got[0] is planes[0] and got[1] is planes[1]
        ahead = tuple(torch.full((2 * B, W), -7, dtype=torch.int32) for _ in range(2))
        fwd = tprep.revcomp_both(_t(w), _t(a), L, ahead)
        for x, y, z, v in zip(got, plain, fwd, want, strict=True):
            _eq(x, v)
            _eq(y, v)
            _eq(z, v)
        words_v, amb_v, planes = _in_place(w, a)
        rw2, ab2, lens2, lm2 = te.device_prep_packed(words_v, amb_v, L, planes)
        for x, v in zip((rw2, ab2, lens2), want):
            _eq(x, v)
        _eq(lm2, np.broadcast_to(te._len_mask_words(L), (2 * B, W)))


@pytest.mark.parametrize("case", ["shifted_rows", "reverse_half", "words_only", "planes_share"])
def test_revcomp_both_refuses_other_overlaps(case):
    """Inputs and outputs may overlap only as the in-place call has them
    (words and amb exactly rows [0, B) of rw2 and ab2); any other overlap
    raises, on the CPU as on the card."""
    rng = np.random.default_rng(3)
    w, a = (np.asarray(x) for x in _packed(rng, 40, 100))
    words_v, amb_v, (rw2, ab2) = _in_place(w, a)
    args = {"shifted_rows": (rw2[1:41], ab2[1:41], (rw2, ab2)),
            "reverse_half": (rw2[40:], ab2[40:], (rw2, ab2)),
            "words_only": (words_v, _t(a), (rw2, ab2)),
            "planes_share": (words_v, amb_v, (rw2, rw2))}[case]
    with pytest.raises(ValueError, match="overlap"):
        tprep.revcomp_both(args[0], args[1], 100, args[2])


def test_device_prep_packed_on_cpu_is_the_plain_version():
    """engine.device_prep_packed's four outputs on CPU tensors: the plain
    revcomp_both and the cached length mask, expanded to 2B rows."""
    rng = np.random.default_rng(5)
    words, amb = _packed(rng, 64, 100)
    rw2, ab2, lens2, lm2 = te.device_prep_packed(_t(words), _t(amb), 100)
    for a, b in zip((rw2, ab2, lens2), tprep.revcomp_both_plain(_t(words), _t(amb), 100),
                    strict=True):
        _eq(a, b)
    _eq(lm2, np.broadcast_to(te._len_mask_words(100), (128, 7)))


def _hits_output_reference(out, k: int, Ct: int, hit_cap: int):
    """bwtpu's "hits" tail (bwtpu/engine.py, the fused list form's `fn`) in
    jnp: keep, compact_mask, the cumsum drop flag, the payload take."""
    cand_c, nm_c, sel, count, overflow, _ = (jnp.asarray(np.asarray(x)) for x in out)
    keep = (nm_c <= k) & (jnp.arange(sel.shape[0], dtype=jnp.int32) < count)
    sel2, cnt2, hover = jcompact.compact(keep, hit_cap)
    drop = keep & (jnp.cumsum(keep.astype(jnp.int32)) > hit_cap)
    overflow = overflow.at[sel // Ct].add(drop.astype(jnp.int32), mode="drop")
    payload = jnp.take(jnp.stack([cand_c, sel * 4 + nm_c], axis=1), sel2, axis=0)
    return payload[:, 0], payload[:, 1], cnt2, hover, overflow > 0


@pytest.mark.parametrize("hit_cap", [1, 40, 200, 4096])
def test_hits_output_drop_matches_the_cumsum_form(hit_cap):
    """hits_output, whose drop flag is now compact's over flag, against the
    reference's tail with `keep & cumsum(keep) > hit_cap`: payload, count,
    hit overflow and the per-row overflow flags (the cap cuts hits at 1,
    40 and 200; 4096 keeps all)."""
    rng = np.random.default_rng(hit_cap)
    B2, Ct, n = 64, 16, 600
    sel = np.sort(rng.choice(B2 * Ct, n, replace=False)).astype(np.int32)
    count = 450
    sel[count:] = 0
    nm = rng.integers(0, 5, size=n).astype(np.int32)
    cand = rng.integers(0, 10**6, size=n).astype(np.int32)
    overflow = (rng.random(B2) < 0.1).astype(np.int32)
    out = (cand, nm, sel, np.int32(count), overflow, np.int32(0))
    got = te.hits_output(tuple(_t(x) for x in out), k=2, Ct=Ct, hit_cap=hit_cap)
    want = _hits_output_reference(out, 2, Ct, hit_cap)
    cnt = int(want[2])
    _eq(got[0][:cnt], np.asarray(want[0])[:cnt], "cand")
    _eq(got[1][:cnt], np.asarray(want[1])[:cnt], "sel * 4 + nm")
    _eq(got[2], want[2], "count")
    _eq(got[5], want[3], "hit overflow")
    _eq(got[6], want[4], "overflow rows")
    assert int(got[3]) == int(np.asarray(want[4]).sum())


# the callers of compact with a capacity flag: (lanes, capacity, density)
CALLERS = {
    "tiered_escalation": (4096, 1024, 0.4),  # esc_dropped, esc_cap of B reads
    "fixup_stragglers": (8192, 1024, 0.2),  # _force_over, max(256, B // 8)
    "hit_compaction": (8192, 4096, 0.6),  # hits_output's drop
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_caller_flags_match_the_cumsum_form(caller):
    """Each caller's flag, now compact's over output, equals the reference's
    `mask & (cumsum(mask) > cap)` on a mask of the caller's shape that
    overruns its capacity; _force_over empties exactly those lanes."""
    n, cap, p = CALLERS[caller]
    rng = np.random.default_rng(n + cap)
    mask = rng.random(n) < p
    *_, over = tcompact.compact(_t(mask), cap)
    want = _cut(mask, cap)
    _eq(over, want, caller)
    assert want.sum() > 0, "the capacity was meant to bind"
    sp = rng.integers(1, 1000, size=n).astype(np.int32)
    ep = sp + rng.integers(1, 50, size=n).astype(np.int32)
    got = tsearch2._force_over(_t(sp), _t(ep), over)
    _eq(got[0], np.where(want, 0, sp))
    _eq(got[1], np.where(want, 0, ep))
    _eq(got[2], want.astype(np.int32))


# csrc/compact.cu's lanes a CTA (a cluster's CTA or a tile)
TILE = 2048
# lane counts: none, one, one CTA's, half a cluster, the cluster's
# capacity at 16 CTAs and one more, the main path's calls (phase 5's block
# k = 0 and 2, the hit compaction, phase 14a's and the human-scale blocks
# k = 0 and 2), the bench's k = 0 and k = 2 calls
PLAN_LANES = [0, 1, 2048, 2049, 16384, 32768, 32769, 65536, 98304, 131072, 262144, 262145,
              393216, 1 << 20, 3 << 20]


@pytest.mark.parametrize("cluster_ctas", [16, 8, 1])
@pytest.mark.parametrize("n", PLAN_LANES)
def test_compact_plan_sizes_and_form(n, cluster_ctas):
    """plan's choice of form and its workspace: the cluster form up to one
    cluster's capacity, on the fewest power-of-two CTAs that hold the
    lanes, with sel, count and overflow alone; the tiles form above, with
    the ticket and a look-back word a tile."""
    cap = 65536
    form, words = tcompact.plan(n, cap, cluster_ctas, TILE)
    if n <= cluster_ctas * TILE:
        assert words == cap + 2
        assert 1 <= form <= cluster_ctas and form & (form - 1) == 0
        assert form * TILE >= n and (form == 1 or (form // 2) * TILE < n)
    else:
        assert form == 0 and words == cap + 3 + -(-n // TILE)
    # on 16 CTAs the main path's k = 0 block call (32,768 lanes) is one
    # cluster; from the hit compaction's 65,536 lanes on, the tiles form
    if cluster_ctas == 16 and n == 32768:
        assert form == 16
    if n >= 65536:
        assert form == 0


@pytest.mark.parametrize("n", PLAN_LANES[1:])
def test_compact_plan_tiles_at_no_cluster(n):
    """With no cluster (cluster_ctas 0) every call of lanes takes the tiles
    form, whose workspace has at least one look-back word."""
    assert tcompact.plan(n, 16, 0, TILE) == (0, 19 + max(1, -(-n // TILE)))


def test_compact_plan_form_edges():
    """At one cluster's capacity the cluster form on the whole cluster;
    one lane more, the tiles form."""
    for cluster_ctas in (16, 8, 4):
        edge = cluster_ctas * TILE
        assert tcompact.plan(edge, 16, cluster_ctas, TILE) == (cluster_ctas, 18)
        assert tcompact.plan(edge + 1, 16, cluster_ctas, TILE) == (
            0, 19 + -(-(edge + 1) // TILE))
