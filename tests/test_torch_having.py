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
from greptimedb_tpu_torch.ops.aggregate import HavingRef, having_mask, having_mask_plain
from test_torch_tile import TSBS, _assert_same, _jax_db, _JaxWriter, _run_pair

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
    from greptimedb_tpu_torch import Database

    ref = _jax_db(str(tmp_path_factory.mktemp("having_jax")))
    port = Database(str(tmp_path_factory.mktemp("having_port")), device="cpu")
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
