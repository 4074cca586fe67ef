"""HAVING on the card: K13 `having_mask` (its plain torch version, which
a CPU tensor runs) against the reference's `having_mask`
(greptimedb_tpu/ops/aggregate.py) on the same seeded [G] states, and the
two HAVING queries of chip_smoke.py's live phase through the port's
Database and the reference's, consumed on the device by both.

Tolerances: the keep masks exactly; query results as in
tests/test_torch_tile.py (keys, counts, max exact; avg within rel
1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from greptimedb_tpu.ops.aggregate import having_mask as r_having_mask
from greptimedb_tpu_torch.ops.aggregate import (
    HavingRef,
    _div_magic,
    _having_program,
    _HavingArgs,
    having_layout,
    having_mask,
    having_mask_plain,
)
from test_torch_tile import TSBS, _assert_same, _jax_db, _JaxWriter, _port_db, _run_pair

MU, AS, N, CW = ("agg", "u", "max"), ("agg", "s", "avg"), ("agg", "__count_star", "count"), \
    ("agg", "w", "count")
D0, D1 = ("dim", 0), ("dim", 1)

TREES = {
    "cmp": ("cmp", ">", MU, 0),
    "cmp_nan_literal": ("cmp", "!=", MU, 4),
    "cmp_nan_value": ("cmp", "<", AS, 1),
    "cmpref": ("cmpref", "<=", AS, MU),
    "cmpref_count": ("cmpref", ">", N, CW),
    "isnull": ("isnull", AS, False),
    "isnotnull": ("isnull", MU, True),
    "isnull_dim": ("isnull", D0, False),
    "not": ("not", ("cmp", ">=", AS, 1)),
    "not_null": ("not", ("cmp", "=", MU, 0)),
    "and": ("and", ("cmp", ">", MU, 0), ("not", ("cmp", ">=", AS, 1))),
    "and_both_null": ("and", ("cmp", ">", MU, 0), ("cmp", "<", AS, 1)),
    "or": ("or", ("cmp", ">", MU, 2), ("cmp", "<", N, 3)),
    "or_null": ("or", ("cmp", "<", AS, 1), ("cmp", ">", MU, 2)),
    "dims": ("and", ("cmp", "=", D1, 3), ("cmp", "!=", D0, 5)),
    "between_not": ("not", ("and", ("cmp", ">=", MU, 2), ("cmp", "<=", MU, 0))),
    "deep": ("or", ("and", ("cmp", ">", MU, 0), ("not", ("cmp", ">=", AS, 1))),
             ("or", ("and", ("cmp", "<", N, 3), ("isnull", AS, False)),
              ("and", ("cmpref", "<=", AS, MU), ("isnull", MU, True)))),
}


def _states(g: int, seed: int):
    """[G] finalized states with empty groups, NULL counts, NaN outputs
    and values tied with the literals."""
    rng = np.random.default_rng(seed)
    presence = rng.integers(0, 4, g).astype(np.int32)
    u_count = np.where(rng.random(g) < 0.2, 0, presence).astype(np.int32)
    w_count = rng.integers(0, 4, g).astype(np.int64)
    mu = np.round(rng.uniform(98, 100, g), 1)
    mu[rng.random(g) < 0.05] = np.nan
    asys = rng.uniform(0, 100, g)
    asys[rng.random(g) < 0.1] = np.nan
    asys[rng.random(g) < 0.05] = 60.0
    lits = np.array([99.5, 60.0, 99.0, 2.0, np.nan, 5.0])
    return presence, u_count, w_count, mu, asys, lits


def _ref_value(presence, u_count, w_count, mu, asys, dims):
    """The reference's `_device_select.ref_val` over the same states."""
    def ref_value(ref):
        if ref[0] == "dim":
            div, card = dims[ref[1]]
            return (jnp.arange(len(presence)) // div) % card, None
        if ref == MU:
            v = jnp.asarray(mu)
            return v, (jnp.asarray(u_count) == 0) | jnp.isnan(v)
        if ref == AS:
            v = jnp.asarray(asys)
            return v, jnp.isnan(v)
        if ref == N:
            return jnp.asarray(presence), None
        return jnp.asarray(w_count), None
    return ref_value


def _port_refs(presence, u_count, w_count, mu, asys, dims):
    t = torch.from_numpy
    return {
        MU: HavingRef(values=t(mu), counts=t(u_count), nan_null=True),
        AS: HavingRef(values=t(asys), nan_null=True),
        N: HavingRef(values=t(presence)),
        CW: HavingRef(values=t(w_count)),
        D0: HavingRef(div=dims[0][0], card=dims[0][1]),
        D1: HavingRef(div=dims[1][0], card=dims[1][1]),
    }


@pytest.mark.parametrize("g", [1, 300, 4096 * 16])
@pytest.mark.parametrize("name", sorted(TREES))
def test_having_mask_equals_reference(name, g):
    presence, u_count, w_count, mu, asys, lits = _states(g, g)
    dims = [(16, max(g // 16, 1)), (1, 16)]
    tree = TREES[name]
    want = np.asarray(r_having_mask(tree, _ref_value(presence, u_count, w_count, mu, asys, dims),
                                    jnp.asarray(lits), (g,)))
    want = want & (presence > 0)
    refs = _port_refs(presence, u_count, w_count, mu, asys, dims)
    got = having_mask(tree, refs, torch.from_numpy(lits), torch.from_numpy(presence))
    assert got.dtype == torch.bool and got.shape == (g,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        having_mask_plain(tree, refs, torch.from_numpy(lits), torch.from_numpy(presence)).numpy(),
        want)


# ---- the two HAVING queries through both Databases ----------------------------------------


@pytest.fixture(scope="module")
def tsbs_pair(tmp_path_factory):
    ref = _jax_db(str(tmp_path_factory.mktemp("having_jax")))
    port = _port_db(str(tmp_path_factory.mktemp("having_port")))
    try:
        chip_smoke.ingest(_JaxWriter(ref), TSBS)
        chip_smoke.ingest(port, TSBS)
        yield port, ref
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("name", [n for n, _sql in chip_smoke.having_queries(TSBS)])
def test_having_query_consumed_on_the_device(tsbs_pair, monkeypatch, name):
    """Both packages fold the HAVING node into the device program (the
    port's spec carries the tree, K13's plain version computes the mask;
    the reference's derive_post_lowering consumes the same node), and the
    results agree."""
    from greptimedb_tpu.query import device_finalize as r_finalize
    from greptimedb_tpu_torch.parallel import tile_planner

    port, ref = tsbs_pair
    sql = dict(chip_smoke.having_queries(TSBS))[name]
    specs, posts = [], []
    real_plan, real_derive = tile_planner.plan_device_finalize, r_finalize.derive_post_lowering

    def spy_plan(*args, **kwargs):
        specs.append(real_plan(*args, **kwargs))
        return specs[-1]

    def spy_derive(*args, **kwargs):
        posts.append(real_derive(*args, **kwargs))
        return posts[-1]

    monkeypatch.setattr(tile_planner, "plan_device_finalize", spy_plan)
    monkeypatch.setattr(r_finalize, "derive_post_lowering", spy_derive)
    got, want = _run_pair(port, ref, sql)
    assert specs and specs[-1] is not None and specs[-1].having is not None
    assert posts and posts[-1] is not None and posts[-1].having == specs[-1].having
    _assert_same(got, want, sql, ordered="ORDER BY" in sql)
    assert got.num_rows > 0


# ---- K13's kernel, emulated (csrc/having_mask.cu) ------------------------------------

U31 = (1 << 31) - 1
_CMP = {0: np.equal, 1: np.not_equal, 2: np.less, 3: np.less_equal, 4: np.greater,
        5: np.greater_equal}


def dim_coord_emulated(g: np.ndarray, div: int, card: int) -> np.ndarray:
    """group_ref.cuh `dim_coord`: (g // div) % card of ids below 2^31 by
    two multiply-highs with the host's `_div_magic` numbers (div and card
    clamped to [1, 2^31 - 1], as the wrapper passes them)."""
    div, card = (min(max(int(x), 1), U31) for x in (div, card))
    (dm, ds), (cm, cs) = _div_magic(div), _div_magic(card)
    g = g.astype(np.uint64)
    q = (g * np.uint64(dm)) >> np.uint64(ds)
    return q - np.uint64(card) * ((q * np.uint64(cm)) >> np.uint64(cs))


def k13_emulated(tree, refs: dict, lits: np.ndarray, presence: np.ndarray) -> np.ndarray:
    """K13 as the kernel runs it: the postfix program of `_having_program`,
    each group's stack held as two uint32 bit masks (bit i = level i's
    value / validity), refs read as group_ref.cuh reads them."""
    code, order = _having_program(tree)
    g = presence.size
    gid = np.arange(g, dtype=np.uint64)

    def value(i):
        r = refs[order[i]]
        if r.values is None:
            return dim_coord_emulated(gid, r.div, r.card).astype(np.float64), np.zeros(g, bool)
        x = r.values.numpy().astype(np.float64)
        null = np.zeros(g, bool) if r.counts is None else r.counts.numpy() == 0
        if r.nan_null and r.values.is_floating_point():
            null = null | np.isnan(x)
        return x, null

    sv, sok, sp = np.zeros(g, np.uint32), np.zeros(g, np.uint32), 0
    for op, a, b, c in code:
        if op <= 2:
            if op == 0:
                x, xn = value(b)
                v, ok = _CMP[a](x, lits[c]), ~xn
            elif op == 1:
                (x, xn), (y, yn) = value(b), value(c)
                v, ok = _CMP[a](x, y), ~xn & ~yn
            else:
                _x, xn = value(a)
                v, ok = (~xn if b else xn), np.ones(g, bool)
            sv |= v.astype(np.uint32) << np.uint32(sp)
            sok |= ok.astype(np.uint32) << np.uint32(sp)
            sp += 1
        elif op == 3:
            sv ^= np.uint32(1 << (sp - 1))
        else:
            bit = lambda m, lvl: ((m >> np.uint32(lvl)) & 1).astype(bool)  # noqa: E731
            bv, bok, av, aok = bit(sv, sp - 1), bit(sok, sp - 1), bit(sv, sp - 2), bit(sok, sp - 2)
            if op == 4:
                v, ok = av & bv, (aok & bok) | (aok & ~av) | (bok & ~bv)
            else:
                v, ok = av | bv, (aok & bok) | (aok & av) | (bok & bv)
            sp -= 1
            keep = np.uint32((1 << (sp - 1)) - 1)
            sv = (sv & keep) | (v.astype(np.uint32) << np.uint32(sp - 1))
            sok = (sok & keep) | (ok.astype(np.uint32) << np.uint32(sp - 1))
    return ((sv & sok & 1) == 1) & (presence > 0)


EVERY_OP = ("or",
            ("and", ("cmp", ">", MU, 0), ("not", ("cmp", ">=", AS, 1))),
            ("or",
             ("and", ("cmp", "<", N, 3), ("isnull", AS, False)),
             ("and", ("cmpref", "<=", AS, MU),
              ("and", ("isnull", MU, True),
               ("or", ("cmp", "=", D1, 3),
                ("and", ("cmp", "!=", D0, 5), ("cmpref", ">", N, CW)))))))
# (div, card) of the two dim refs: divisors and cards at 1, at and around
# powers of two, odd, and past G
DIM_EDGES = [((1, 1), (1, 1)), ((16, 4096), (1, 16)), ((3, 7), (1, 3)), ((255, 257), (1, 255)),
             ((1 << 12, (1 << 12) + 1), ((1 << 12) - 1, 1 << 12)), ((U31, U31), (1, U31)),
             ((1 << 40, 5), (1 << 30, 1 << 33))]


@pytest.mark.parametrize("dims", DIM_EDGES, ids=lambda d: f"{d[0]}-{d[1]}")
@pytest.mark.parametrize("name", sorted(TREES) + ["every_op"])
def test_having_kernel_emulation_matches_reference(name, dims):
    """K13's register bit stack over the postfix program, with dim refs by
    multiply-highs, emulated, equals the reference's Kleene evaluation
    (every op, NULL counts, NaN values and literals, dims at div and card
    edges)."""
    g = 5000
    presence, u_count, w_count, mu, asys, lits = _states(g, 77)
    tree = EVERY_OP if name == "every_op" else TREES[name]
    want = np.asarray(r_having_mask(tree, _ref_value(presence, u_count, w_count, mu, asys, dims),
                                    jnp.asarray(lits), (g,))) & (presence > 0)
    refs = _port_refs(presence, u_count, w_count, mu, asys, dims)
    np.testing.assert_array_equal(k13_emulated(tree, refs, lits, presence), want)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 10, 60, 255, 256, 257, 4095, 4096, 4097, 86_400,
                               (1 << 30) - 1, 1 << 30, (1 << 30) + 1, U31 - 1, U31])
def test_dim_divisor_magic_is_exact_below_2_31(d):
    """`_div_magic`'s multiply-high equals floor division for every id
    below 2^31: around each multiple of d, at the ends and at random."""
    rng = np.random.default_rng(d % 10007)
    ks = np.unique(np.concatenate([np.arange(0, 64), rng.integers(0, U31 // d + 1, 200),
                                   [U31 // d - 1, U31 // d]]))
    n = (ks[:, None] * d + np.array([-1, 0, 1, d - 1])[None, :]).ravel()
    n = np.concatenate([n, [0, 1, U31 - 2, U31 - 1], rng.integers(0, U31, 2000)])
    n = np.unique(n[(n >= 0) & (n < U31)]).astype(np.uint64)
    mul, shift = _div_magic(d)
    assert mul < 1 << 32
    np.testing.assert_array_equal((n * np.uint64(mul)) >> np.uint64(shift), n // np.uint64(d))
    for card in (1, 3, d, U31):
        np.testing.assert_array_equal(dim_coord_emulated(n, d, card),
                                      (n // np.uint64(d)) % np.uint64(card))


def test_having_layout_is_built_once_per_structure():
    """K13's program is built once per structure: new literals (the tile
    program's rewritten input buffer) and new planes of the same kinds
    reuse it and give the new mask; a new tree misses the cache.  The
    template holds the postfix program and the dim multipliers."""
    g = 4096
    presence, u_count, w_count, mu, asys, lits = _states(g, 9)
    dims = [(16, 256), (1, 16)]
    refs = _port_refs(presence, u_count, w_count, mu, asys, dims)
    tree = TREES["deep"]
    lay = having_layout(tree, refs, torch.int32)
    refs2 = _port_refs(presence.copy(), u_count.copy(), w_count.copy(), mu.copy(), asys.copy(),
                       dims)
    assert having_layout(tree, refs2, torch.int32) is lay
    assert having_layout(TREES["and"], refs, torch.int32) is not lay
    assert having_layout(tree, refs, torch.int64) is not lay
    code, order = _having_program(tree)
    a = _HavingArgs.from_buffer_copy(lay.template)
    assert a.n_code == len(code) and lay.order == order
    assert [tuple(a.code[i]) for i in range(a.n_code)] == list(code)
    for lit in (lits, lits + 0.5, lits[::-1].copy()):
        want = np.asarray(r_having_mask(
            tree, _ref_value(presence, u_count, w_count, mu, asys, dims), jnp.asarray(lit),
            (g,))) & (presence > 0)
        np.testing.assert_array_equal(k13_emulated(tree, refs2, lit, presence), want)
        np.testing.assert_array_equal(
            having_mask(tree, refs2, torch.from_numpy(lit), torch.from_numpy(presence)).numpy(),
            want)
    d = [r for r in refs if r[0] == "dim"]
    dim_refs = {r: refs[r] for r in d}
    lay_d = having_layout(("and", ("cmp", "=", D0, 0), ("cmp", "<", D1, 1)), dim_refs,
                          torch.int32)
    c = _HavingArgs.from_buffer_copy(lay_d.template).refs[0]
    assert (c.card, (c.div_mul, c.div_shift)) == (256, _div_magic(16))


# ---- the select stage (TileProgram.device_select), refs passed through ----------------


def _reference_select(prog, merged, outs, presence, hv):
    """The reference's `_device_select` (greptimedb_tpu/parallel/
    tile_cache.py) over the same states: its ref_val, having_mask and
    topk_group_select."""
    from greptimedb_tpu.ops.aggregate import topk_group_select as r_topk

    plan, spec = prog.plan, prog.spec
    g = presence.shape[0]
    gid = jnp.arange(g, dtype=jnp.int32)
    dims = list(plan.tag_cards) + ([plan.n_buckets] if plan.bucket_col is not None else [])
    pres = jnp.asarray(presence.numpy())

    def ref_val(ref):
        if ref[0] == "dim":
            div = int(np.prod(dims[ref[1] + 1:], dtype=np.int64))
            return (gid // div) % dims[ref[1]], None
        _kind, col, agg = ref
        if col == "__count_star" or col not in merged:
            return pres, None
        counts = merged[col].counts
        if agg == "count":
            return (jnp.asarray(counts.numpy()) if counts is not None else pres), None
        isnull = None if counts is None else jnp.asarray(counts.numpy()) == 0
        v = jnp.asarray(outs[col][agg].numpy())
        if jnp.issubdtype(v.dtype, jnp.floating):
            isnull = jnp.isnan(v) if isnull is None else isnull | jnp.isnan(v)
        return v, isnull

    mask = pres > 0
    if spec.having is not None:
        mask = mask & r_having_mask(spec.having, ref_val, jnp.asarray(hv.numpy()), (g,))
    keys = [(*ref_val(ref), asc, nf) for ref, asc, nf in spec.order]
    return r_topk(mask, keys, spec.cap)


@pytest.mark.parametrize("query", chip_smoke.SELECT_QUERIES)
def test_device_select_passes_refs_through(query, monkeypatch):
    """device_select at groupby-orderby-limit's and the live HAVING
    queries' shapes hands K7 the states as they lie — presence as the gate
    without HAVING, K13's mask with it, each ORDER BY ref as a HavingRef
    (no torch op in between) — and gives the reference's selection."""
    from greptimedb_tpu_torch.parallel import tile_program as tp

    seen = []
    real = tp.topk_group_select

    def spy(mask, order_keys, cap):
        seen.append((mask, order_keys, cap))
        return real(mask, order_keys, cap)

    monkeypatch.setattr(tp, "topk_group_select", spy)
    prog, args, _plain = chip_smoke.select_inputs(query, torch.device("cpu"))
    sel, n_out = prog.device_select(*args)
    (gate, keys, cap), = seen
    presence = args[2]
    if prog.spec.having is None:
        assert gate is presence
    else:
        assert gate.dtype == torch.bool
    assert all(len(k) == 3 and isinstance(k[0], HavingRef) for k in keys)
    r_sel, r_n = _reference_select(prog, *args)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(r_sel))
    assert int(n_out[0]) == int(r_n)
