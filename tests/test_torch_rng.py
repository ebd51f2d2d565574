"""The port's counter RNG against the reference's numpy path, bitwise:
``_mix32``, ``_uniforms`` (lane ids near the 2^32 wrap, many steps, large
step counters), the geometric tables and ``_geometric_multi``, and the
initial node state."""
import numpy as np
import pytest
import torch

from repro.core import availability_batched as ref
from repro_torch.core import availability_batched as port

RNG = np.random.default_rng(20)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def test_mix32_matches_reference():
    x = np.concatenate([
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], dtype=np.uint32),
        RNG.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)])
    want = ref._mix32(x, np)
    got = port._mix32(_t(x))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # python ints take the same path (the per-step key is hashed on host)
    assert [port._mix32(int(v)) for v in x[:64]] == want[:64].tolist()


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 + 5, -3])
def test_uniforms_match_reference_near_lane_wrap(seed):
    n = 17
    lane0 = np.array([2 ** 32 - 5, 2 ** 32 - n - 1, 0, 12345, 2 ** 31 - 3],
                     dtype=np.uint32)
    seed_mix_np = ref._mix32(np.asarray([(seed & 0xFFFFFFFF) ^ 0x6A09E667],
                                        dtype=np.uint32), np)
    seed_mix = port._seed_mix(seed)
    assert seed_mix == int(seed_mix_np[0])
    lanes = port._lane_keys(_t(lane0), n)
    steps = list(range(0, 300)) + [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    for salt in (ref._GEO_SALT, ref._PAIR_SALT):
        for s in steps:
            want = ref._uniforms(seed_mix_np, np.asarray(s, dtype=np.uint32),
                                 salt, lane0, n, np)
            got = port._uniforms(seed_mix, s, salt, lanes)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want), (salt, s)


def test_geometric_multi_matches_reference():
    n, gap_cap = 24, 60_000
    p_arr = np.array([5e-4, 1e-3, 4e-3, 0.2])[np.arange(n) % 4]
    masks_np, tables_np = ref._geo_tables(p_arr, gap_cap, np)
    masks, tables = port._geo_tables(p_arr, gap_cap, "cpu")
    for a, b in zip(tables_np, tables):
        assert np.array_equal(a, b.numpy())
    seed_mix_np = ref._mix32(np.asarray([0x6A09E667], dtype=np.uint32), np)
    lane0 = np.arange(6, dtype=np.uint32) * np.uint32(n)
    lanes = port._lane_keys(_t(lane0), n)
    for s in range(200):
        u_np = ref._uniforms(seed_mix_np, np.asarray(s, dtype=np.uint32),
                             ref._GEO_SALT, lane0, n, np)
        want = ref._geometric_multi(u_np, masks_np, tables_np, np)
        got = port._geometric_multi(
            port._uniforms(port._seed_mix(0), s, ref._GEO_SALT, lanes),
            masks, tables)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    # extreme uniforms: 0, the largest 24-bit value, CDF plateaus
    u = torch.tensor([[0.0, 1.0 - 2.0 ** -24, float(tables[0][-1]),
                       float(tables[0][0])]], dtype=torch.float32)
    want = ref._geometric(u.numpy(), tables_np[0], np)
    assert np.array_equal(port._geometric(u, tables[0]).numpy(), want)


@pytest.mark.parametrize("restart_period", [0, 700])
def test_initial_node_state_matches_reference(restart_period):
    n, B, horizon = 11, 5, 9_000
    p_arr = np.full(n, 3e-3)
    masks_np, tables_np = ref._geo_tables(p_arr, horizon + 12, np)
    masks, tables = port._geo_tables(p_arr, horizon + 12, "cpu")
    seed_mix_np = ref._mix32(np.asarray([9 ^ 0x6A09E667], dtype=np.uint32),
                             np)
    want = ref._initial_node_state(
        np, B=B, n=n, seed_mix=seed_mix_np, geo_masks=masks_np,
        geo_tables=tables_np, restart_period=restart_period,
        horizon=horizon)
    got = port._initial_node_state(
        B=B, n=n, seed_mix=port._seed_mix(9), geo_masks=masks,
        geo_tables=tables, restart_period=restart_period, horizon=horizon,
        device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), w)
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
