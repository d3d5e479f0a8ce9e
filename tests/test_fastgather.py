"""ops/fastgather.py — the small-table gather strategies must be EXACTLY
equivalent to plain takes (they replaced every hot-path gather in round 3;
see PROFILE_r03.md for why)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from pbrt_tpu.ops import fastgather as fg


def _tables(n, rng):
    return {
        "f32_1d": jnp.asarray(rng.rand(n).astype(np.float32)),
        "f32_2d": jnp.asarray(rng.rand(n, 3).astype(np.float32)),
        "f32_3d": jnp.asarray(rng.rand(n, 4, 3).astype(np.float32)),
        "i32": jnp.asarray(rng.randint(-5, 1 << 20, (n, 2)).astype(
            np.int32)),
        "bool": jnp.asarray(rng.rand(n, 3) > 0.5),
    }


def test_gather_rows_matches_take_all_strategies():
    rng = np.random.RandomState(0)
    R = 257
    # n spans the select-chain (<=32), one-hot (<=512) and take (>512)
    # strategies
    for n in (1, 4, 31, 33, 300, 600):
        idx = jnp.asarray(rng.randint(-2, n + 2, R).astype(np.int32))
        clipped = np.clip(np.asarray(idx), 0, n - 1)
        for name, tab in _tables(n, rng).items():
            got = np.asarray(fg.gather_rows(tab, idx))
            want = np.asarray(tab)[clipped]
            np.testing.assert_array_equal(got, want, err_msg=f"{name} n={n}")


def test_gather_tree_shares_strategy_and_skips_foreign_leaves():
    rng = np.random.RandomState(1)
    n = 7

    @jax.tree_util.register_dataclass
    @dataclasses.dataclass
    class T:
        a: jnp.ndarray
        b: jnp.ndarray
        other: jnp.ndarray   # leading dim != n → passes through

    t = T(a=jnp.asarray(rng.rand(n, 3).astype(np.float32)),
          b=jnp.asarray(rng.randint(0, 9, n).astype(np.int32)),
          other=jnp.asarray(np.arange(5, dtype=np.float32)))
    idx = jnp.asarray(rng.randint(0, n, 64).astype(np.int32))
    out = fg.gather_tree(t, idx, n)
    np.testing.assert_array_equal(np.asarray(out.a),
                                  np.asarray(t.a)[np.asarray(idx)])
    np.testing.assert_array_equal(np.asarray(out.b),
                                  np.asarray(t.b)[np.asarray(idx)])
    np.testing.assert_array_equal(np.asarray(out.other),
                                  np.asarray(t.other))


def test_select_component_and_row():
    rng = np.random.RandomState(2)
    R = 129
    v = jnp.asarray(rng.rand(R, 3).astype(np.float32))
    ax = jnp.asarray(rng.randint(0, 3, R).astype(np.int32))
    np.testing.assert_array_equal(
        np.asarray(fg.select_component(v, ax)),
        np.take_along_axis(np.asarray(v), np.asarray(ax)[:, None],
                           axis=-1)[:, 0])
    vi = jnp.asarray(rng.randint(0, 7, (R, 3)).astype(np.int32))
    got_i = np.asarray(fg.select_component(vi, ax))
    np.testing.assert_array_equal(
        got_i, np.take_along_axis(np.asarray(vi), np.asarray(ax)[:, None],
                                  axis=-1)[:, 0])
    m = 4
    w = jnp.asarray(rng.rand(R, m, 2).astype(np.float32))
    sl = jnp.asarray(rng.randint(0, m, R).astype(np.int32))
    want = np.asarray(w)[np.arange(R), np.asarray(sl)]
    np.testing.assert_array_equal(np.asarray(fg.select_row(w, sl)), want)


def test_make_row_gather_under_jit_and_grad():
    """The gather must stay exact under jit and be differentiable w.r.t.
    the table (the bench differentiates through material-row gathers)."""
    rng = np.random.RandomState(3)
    n, R = 4, 64
    tab = jnp.asarray(rng.rand(n, 3).astype(np.float32))
    idx = jnp.asarray(rng.randint(0, n, R).astype(np.int32))

    @jax.jit
    def f(tab):
        g = fg.make_row_gather(n, idx)
        return jnp.sum(g(tab) ** 2)

    got = float(f(tab))
    want = float(np.sum(np.asarray(tab)[np.asarray(idx)] ** 2))
    assert abs(got - want) < 1e-4
    grad = np.asarray(jax.grad(f)(tab))
    # d/dtab sum(tab[idx]^2) = 2 * tab[row] * count(row)
    counts = np.bincount(np.asarray(idx), minlength=n)[:, None]
    np.testing.assert_allclose(grad, 2 * np.asarray(tab) * counts,
                               rtol=1e-5)
