"""The §5.2 micro-simulator's arrivals pre-pass and its two-table entry:
``core/microsim.arrivals_plain`` bitwise against the reference's own draws
(``jax.random.split`` and ``uniform`` with its rate accumulator, as
``repro/core/microsim.py: _simulate_batch`` makes them); the tick loop fed
by it, both tables in one grid with each table's own counters, equal to
the reference table by table; and ``run_tables`` equal to one
``run_table`` per table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import microsim as ref
from repro_torch.core import microsim as port
from repro_torch.kernels import microsim_scan as ms

torch.set_num_threads(1)


def _ref_arrivals(configs, ticks):
    """(n_read, n_write) (R, ticks) as the reference's step draws them,
    under jit as ``_sim_jit`` runs it (XLA's arithmetic of rate_pt)."""
    R = configs[0].shape[0]

    def run(rs, ps, bw, u, lf, rf):
        rate_pt = u * bw / (rf * rs + (1 - rf) * 2 * lf * rs) / \
            ref.TICKS_PER_S

        def step(carry, _):
            acc, key = carry
            acc = acc + rate_pt
            n_arr = jnp.floor(acc)
            acc = acc - n_arr
            key, sub = jax.random.split(key)
            r_draw = jax.random.uniform(sub, (R, ref.MAX_ARR))
            arr = jnp.arange(ref.MAX_ARR)[None, :] < n_arr[:, None]
            return (acc, key), (
                jnp.sum(arr & (r_draw < rf[:, None]), axis=1),
                jnp.sum(arr & (r_draw >= rf[:, None]), axis=1))

        return jax.lax.scan(step, (jnp.zeros(R, jnp.float32),
                                   jax.random.PRNGKey(0)), None,
                            length=ticks)[1]

    reads, writes = jax.jit(run)(*(jnp.asarray(c.numpy()) for c in configs))
    return np.asarray(reads).T, np.asarray(writes).T


@pytest.mark.parametrize("table", sorted(port.TABLES))
def test_arrivals_equal_the_reference_draws(table):
    configs = ms.case_configs(table, 1.0, "cpu")
    ticks = 2500
    k = port.row_constants(*configs)
    got = port.arrivals_plain(k["rate_pt"], configs[5], ticks, 0)
    want = _ref_arrivals(configs, ticks)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    assert got[0].sum() > 0 and got[1].sum() > 0
    assert (got[0] + got[1]).max() <= port.MAX_ARR


def test_arrivals_of_concatenated_tables_draw_per_table():
    """Rows r and r + 12 of the two tables' grids draw with one counter:
    each table's arrivals as if drawn alone."""
    tables = sorted(port.TABLES)
    configs = [torch.cat(cs) for cs in zip(*(ms.case_configs(t, 1.0, "cpu")
                                             for t in tables))]
    k = port.row_constants(*configs)
    both = port.arrivals_plain(k["rate_pt"], configs[5], 1100, 0,
                               draw_rows=12)
    for i, t in enumerate(tables):
        alone = ms.case_configs(t, 1.0, "cpu")
        ka = port.row_constants(*alone)
        want = port.arrivals_plain(ka["rate_pt"], alone[5], 1100, 0)
        for g, w in zip(both, want):
            assert torch.equal(g[12 * i:12 * (i + 1)], w)
    # drawn as one 24-row table instead, the second table's rows differ
    one = port.arrivals_plain(k["rate_pt"], configs[5], 1100, 0)
    assert not torch.equal(one[0][12:], both[0][12:])


@pytest.mark.parametrize("mode", ms.MODES)
def test_two_tables_in_one_grid_equal_the_reference(mode):
    """The tick loop over both tables' grids in one call, fed by the
    pre-pass with each table's counters, equals the reference's
    ``_sim_jit`` of each table, bit for bit."""
    tables = sorted(port.TABLES)
    ticks = 2100
    per = [ms.case_configs(t, 1.0, "cpu") for t in tables]
    configs = [torch.cat(cs) for cs in zip(*per)]
    got = ms.microsim_scan(*configs, ticks=ticks, rows_per_table=12)[mode]
    for i, cs in enumerate(per):
        want = ref._sim_jit(*(jnp.asarray(c.numpy()) for c in cs),
                            mode == "lark", ticks, 0)
        for key, w in want.items():
            g = got[key][12 * i:12 * (i + 1)].numpy()
            assert np.array_equal(g.view(np.uint32),
                                  np.asarray(w).view(np.uint32)), (i, key)


def test_run_tables_equals_run_table_per_table():
    tables = {name: port.table_configs(u, lf)[:3]
              for name, (u, lf) in port.TABLES.items()}
    both = port.run_tables(tables, ticks=2100, device="cpu")
    assert list(both) == list(tables)
    for name, configs in tables.items():
        alone = port.run_table(configs, ticks=2100, device="cpu")
        assert len(both[name]) == len(alone) == 3
        for g, w in zip(both[name], alone):
            assert g.keys() == w.keys()
            for key in w:
                if isinstance(w[key], np.ndarray):
                    assert np.array_equal(g[key], w[key]), key
                else:
                    assert g[key] == w[key], key


def test_rows_per_table_must_divide_the_rows():
    configs = ms.case_configs("t3", 1.0, "cpu")
    with pytest.raises(ValueError, match="divide"):
        ms.microsim_scan(*configs, ticks=10, rows_per_table=5)
    with pytest.raises(ValueError, match="one length"):
        port.run_tables({"a": port.table_configs(0.5, 0.5)[:2],
                         "b": port.table_configs(0.5, 0.5)[:3]},
                        ticks=10, device="cpu")


def test_launch_args_carry_the_key_chain_scratch():
    """The launcher's arguments: rows per table beside R, the sub-key
    array (two words a tick) and the progress counter as scratch."""
    configs = ms.case_configs("t4", 1.0, "cpu")
    both = [torch.cat([c, c]) for c in configs]
    out, args, (kept, subs, progress) = ms.launch_args(
        *both, ticks=300, rows_per_table=12)
    assert len(args) + 1 == len(ms._ARGTYPES)
    assert args[6:9] == (24, 12, 300)
    assert subs.shape == (300, 2) and progress.numel() == 1
    assert out["lark"]["per_tick_done"].shape == (24, 300)
    _, args1, _ = ms.launch_args(*configs, ticks=300)
    assert args1[6:8] == (12, 12)
