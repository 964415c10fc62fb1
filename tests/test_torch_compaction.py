"""The pieces of the port's fused and segmented engines against the JAX
package and against what they replace, on the CPU:

* the compaction helpers (``compact_stack``, ``pow2_bucket``, the server
  state's gather and scatter) equal the JAX package's on the same numpy
  inputs, exactly, and gather then scatter round-trips;
* the blocking table equals ``betainc(...) > delta`` at every count it
  covers, and scipy's ``betainc`` agrees;
* the unrolled AFA screening equals the stopping loop bit for bit;
* the keyed Philox streams: Random123's known answers, the same draws for a
  client whatever its row, distinct streams for distinct (round, client);
* client-axis sums that do not depend on a live row's position;
* one fused round body on ``device="meta"``, where any host read raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.special  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.fed as jfed  # noqa: E402
from repro.core import ReputationState as JReputationState  # noqa: E402
from repro_torch.convert import server_state_from_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AFAConfig,
    ReputationState,
    afa_aggregate,
    betainc,
    blocked_by_table,
    blocking_table,
    update_reputation,
)
from repro_torch.core.stats import masked_mean, masked_std, row_sum  # noqa: E402
from repro_torch.data import compact_stack, padded_stack, pow2_bucket  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    DnnWorkload,
    EngineConfig,
    FusedData,
    ServerConfig,
    ServerState,
    gather_server_state,
    make_fused_sim,
    make_rule_options,
    scatter_server_state,
)
from repro_torch.utils.philox import (  # noqa: E402
    M32,
    keyed_bits,
    keyed_normal,
    keyed_randint,
    keyed_words,
    philox4x32,
)

RNG = np.random.default_rng(20)


# ------------------------- layout helpers ------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shards(lengths, feat=(4,)):
    return [(RNG.normal(size=(n,) + feat).astype(np.float32), RNG.integers(0, 5, n))
            for n in lengths]


@pytest.mark.parametrize("keep,pad_to", [
    ([0, 2], None), ([1], 4), ([0, 1, 2, 3, 4], 8), ([3, -1, 0, -1], 6), ([], 2),
])
def test_compact_stack_equals_jax(keep, pad_to):
    shards = _shards((5, 3, 7, 2, 6))
    x, y, lengths = padded_stack(shards)
    jx, jy, jlengths = jdata.padded_stack(shards)
    for a, b in zip((x, y, lengths), (jx, jy, jlengths)):
        np.testing.assert_array_equal(a, b)
    got = compact_stack(x, y, lengths, np.asarray(keep, np.int64), pad_to=pad_to)
    want = jdata.compact_stack(jx, jy, jlengths, np.asarray(keep, np.int64), pad_to=pad_to)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_compact_stack_refuses_to_truncate():
    x, y, lengths = padded_stack(_shards((2, 3, 4)))
    with pytest.raises(ValueError, match="truncate"):
        compact_stack(x, y, lengths, [0, 1, 2], pad_to=2)


def test_pow2_bucket_equals_jax():
    for cap in (1, 2, 7, 8, 10, 16, 200):
        for n in range(0, cap + 3):
            assert pow2_bucket(n, cap) == jdata.pow2_bucket(n, cap), (n, cap)


def _random_state_np(K, seed):
    rng = np.random.default_rng(seed)
    alpha = (3.0 + rng.integers(0, 6, K)).astype(np.float32)
    beta = (3.0 + rng.integers(0, 8, K)).astype(np.float32)
    blocked = rng.random(K) < 0.4
    rounds_blocked = np.where(blocked, rng.integers(1, 9, K), -1).astype(np.int32)
    return jfed.ServerState(JReputationState(alpha, beta, blocked), rounds_blocked,
                            np.int32(7))


def _leaves(state):
    return [np.asarray(state.reputation.alpha), np.asarray(state.reputation.beta),
            np.asarray(state.reputation.blocked), np.asarray(state.rounds_blocked)]


def _torch_leaves(state):
    return [t.numpy() for t in (state.reputation.alpha, state.reputation.beta,
                                state.reputation.blocked, state.rounds_blocked)]


@pytest.mark.parametrize("K,seed", [(9, 0), (10, 1), (16, 2)])
def test_gather_scatter_server_state_equal_jax_and_roundtrip(K, seed):
    np_state = _random_state_np(K, seed)
    jstate = jax.tree_util.tree_map(jnp.asarray, np_state)
    tstate = server_state_from_numpy(np_state, device="cpu")
    tstate = tstate._replace(round=torch.tensor(7, dtype=torch.int32))
    keep = np.nonzero(~np_state.reputation.blocked)[0]
    bucket = pow2_bucket(len(keep), K)
    tc = gather_server_state(tstate, keep, bucket)
    jc = jfed.gather_server_state(jstate, jnp.asarray(keep), bucket)
    for a, b in zip(_torch_leaves(tc), _leaves(jc)):
        np.testing.assert_array_equal(a, b)
    assert int(tc.round) == 7
    # a compacted round: the kept rows change, then scatter back
    tc2 = tc._replace(reputation=tc.reputation._replace(alpha=tc.reputation.alpha + 1.0))
    jc2 = jc._replace(reputation=jc.reputation._replace(alpha=jc.reputation.alpha + 1.0))
    tfull = scatter_server_state(tstate, tc2, keep)
    jfull = jfed.scatter_server_state(jstate, jc2, keep)
    for a, b in zip(_torch_leaves(tfull), _leaves(jfull)):
        np.testing.assert_array_equal(a, b)
    # gather then scatter of an unchanged compact state is the identity
    back = scatter_server_state(tstate, tc, keep)
    for a, b in zip(_torch_leaves(back), _torch_leaves(tstate)):
        np.testing.assert_array_equal(a, b)


def test_gather_server_state_interleaved_pads_equal_jax():
    np_state = _random_state_np(8, 3)
    jstate = jax.tree_util.tree_map(jnp.asarray, np_state)
    tstate = server_state_from_numpy(np_state, device="cpu")
    keep = np.asarray([1, 4, -1, 6, -1], np.int64)
    tc = gather_server_state(tstate, keep, 8)
    jc = jfed.gather_server_state(jstate, jnp.asarray(keep), 8)
    for a, b in zip(_torch_leaves(tc), _leaves(jc)):
        np.testing.assert_array_equal(a, b)
    tfull = scatter_server_state(tstate, tc, keep)
    jfull = jfed.scatter_server_state(jstate, jc, keep)
    for a, b in zip(_torch_leaves(tfull), _leaves(jfull)):
        np.testing.assert_array_equal(a, b)


# ------------------------- blocking table ------------------------------------

TABLE_N = 200


# delta is kept off the dyadic rationals: at integer counts I_0.5(a, b) is a
# binomial tail m / 2^n, so delta = 0.5 would put every a = b on a tie
@pytest.mark.parametrize("alpha0,beta0,delta", [(3.0, 3.0, 0.95), (1.0, 1.0, 0.9),
                                                (2.5, 4.0, 0.99), (3.0, 3.0, 0.6)])
def test_blocking_table_equals_betainc(alpha0, beta0, delta):
    table = blocking_table(alpha0, beta0, delta, TABLE_N)
    assert table.shape == (TABLE_N + 1,) and table.dtype == np.int64
    counts = np.arange(TABLE_N + 1, dtype=np.float32)
    a = torch.from_numpy(np.float32(alpha0) + counts)
    b = torch.from_numpy(np.float32(beta0) + counts)
    over = np.zeros((TABLE_N + 1, TABLE_N + 1), bool)
    for g in range(TABLE_N + 1):   # one row at a time: each row its own betainc call
        over[g] = (betainc(a[g], b, 0.5) > delta).numpy()
    want = np.where(over.any(axis=1), over.argmax(axis=1), TABLE_N + 1)
    np.testing.assert_array_equal(table, want)
    # blocking rises with the bad count: the table is a threshold per row
    gb = np.arange(TABLE_N + 1)
    np.testing.assert_array_equal(over, gb[None, :] >= table[:, None])
    # and scipy's regularized incomplete beta agrees
    ref = scipy.special.betainc(a.numpy()[:, None].astype(np.float64),
                                b.numpy()[None, :].astype(np.float64), 0.5) > delta
    np.testing.assert_array_equal(over, ref)


def test_blocked_by_table_matches_betainc_on_states():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(blocking_table(3.0, 3.0, 0.95, 40))
    alpha = torch.from_numpy((3.0 + rng.integers(0, 20, 64)).astype(np.float32))
    beta = torch.from_numpy((3.0 + rng.integers(0, 20, 64)).astype(np.float32))
    got = blocked_by_table(alpha, beta, table, 3.0, 3.0)
    want = betainc(alpha, beta, 0.5) > 0.95
    assert torch.equal(got, want)
    # pad rows of a compacted state: negative counts, clamped, not an error
    pads = blocked_by_table(torch.ones(3), torch.ones(3), table, 3.0, 3.0)
    assert pads.shape == (3,)


def test_update_reputation_table_equals_betainc_over_rounds():
    rng = np.random.default_rng(9)
    K, T = 12, 30
    table = (torch.from_numpy(blocking_table(3.0, 3.0, 0.95, T)), 3.0, 3.0)
    a = b = ReputationState(torch.full((K,), 3.0), torch.full((K,), 3.0),
                            torch.zeros(K, dtype=torch.bool))
    for _ in range(T):
        good = torch.from_numpy(rng.random(K) < 0.6)
        part = torch.from_numpy(rng.random(K) < 0.9)
        a = update_reputation(a, good, part, delta=0.95)
        b = update_reputation(b, good, part, delta=0.95, table=table)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert bool(a.blocked.any())


# ------------------------- AFA: unrolled = stopping loop ----------------------


def _screen_inputs(K, D, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=D).astype(np.float32)
    U = base + 0.3 * rng.normal(size=(K, D)).astype(np.float32)
    U[:3] = base + 4.0 * rng.normal(size=(3, D)).astype(np.float32)
    U[3] = -U[3]
    n = rng.integers(50, 150, K).astype(np.float32)
    p = rng.uniform(0.3, 0.9, K).astype(np.float32)
    mask = rng.random(K) < 0.9
    return [torch.from_numpy(a) for a in (U, n, p, mask)]


@pytest.mark.parametrize("variant,launch", [("iterative", "fused"), ("gram", "chained"),
                                            ("gram", "fused")])
@pytest.mark.parametrize("max_rounds", [0, 1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unrolled_screening_equals_the_loop(variant, launch, max_rounds, seed):
    U, n, p, mask = _screen_inputs(12, 300, seed)
    cfg = AFAConfig(variant=variant, kernel_launch=launch, max_rounds=max_rounds,
                    xi0=1.0, delta_xi=0.25)
    loop = afa_aggregate(U, n, p, mask, cfg)
    unrolled = afa_aggregate(U, n, p, mask, cfg, unroll=True)
    for a, b in zip(loop[:4], unrolled[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if max_rounds >= 3:
        assert int(loop.rounds) >= 2   # the inputs make the loop run passes


# ------------------------- keyed Philox streams ------------------------------

# Random123's known-answer vectors of philox4x32_10
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert philox4x32(ctr, key) == want
    got = philox4x32(tuple(torch.tensor(c) for c in ctr), tuple(torch.tensor(k) for k in key))
    assert tuple(int(w) for w in got) == want


def test_keyed_words_equal_the_python_reference():
    seed, stream = (3 << 32) + 17, 0xABCDE
    offsets = torch.tensor([0, 5, 12345, 2**31 + 7])
    words = keyed_words(torch.tensor(seed), stream, offsets, 11)
    assert words.dtype == torch.int64 and words.shape == (4, 11)
    for r, off in enumerate(offsets.tolist()):
        for e in range(11):
            ref = philox4x32((e // 4, off, stream, 0), (seed & M32, seed >> 32))[e % 4]
            assert int(words[r, e]) == ref


def test_keyed_draws_follow_the_client_not_the_row():
    """A client's draws depend on its id: the compacted layout (live ids
    first, pads with id 0) gives every live client the rows it had."""
    seed, K, rnd = torch.tensor(3), 10, 4
    ids = torch.arange(K)
    kept = torch.tensor([4, 5, 7, 9, 0, 0, 0, 0])   # 4 live + pads
    full_off, comp_off = rnd * K + ids, rnd * K + kept
    lengths = torch.arange(1, K + 1) * 37
    for draw in (lambda o, ln: keyed_words(seed, 7, o, 50),
                 lambda o, ln: keyed_bits(seed, 7, o, 1000),
                 lambda o, ln: keyed_randint(seed, 7, o, 64, ln),
                 lambda o, ln: keyed_normal(seed, 7, o, 33)):
        full = draw(full_off, lengths)
        comp = draw(comp_off, lengths[kept])
        assert torch.equal(comp[:4], full[kept[:4]])


def test_keyed_streams_are_distinct_and_well_formed():
    seed, K, T = torch.tensor(0), 10, 6
    offsets = torch.arange(T * K)              # every (round, client) of a run
    words = keyed_words(seed, 1, offsets, 64)
    assert len({tuple(r) for r in words.tolist()}) == T * K
    assert not torch.equal(keyed_words(seed, 1, offsets[:3], 8),
                           keyed_words(seed, 2, offsets[:3], 8))
    assert not torch.equal(keyed_words(seed, 1, offsets[:3], 8),
                           keyed_words(torch.tensor(1), 1, offsets[:3], 8))
    assert int(words.min()) >= 0 and int(words.max()) <= M32
    bits = keyed_bits(seed, 1, offsets, 4096).float()
    assert abs(float(bits.mean()) - 0.5) < 0.005
    high = torch.arange(1, T * K + 1)
    idx = keyed_randint(seed, 1, offsets, 500, high)
    assert bool((idx >= 0).all()) and bool((idx < high[:, None]).all())
    z = keyed_normal(seed, 1, offsets, 2000)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02


# ------------------------- client-axis sums ----------------------------------


def test_client_axis_sums_do_not_depend_on_row_position():
    """Moving the live rows to the front, as compaction does, gives the same
    bits: the folds add live rows in order and dead rows add exact zeros."""
    rng = np.random.default_rng(1)
    for _ in range(50):
        live = torch.from_numpy(rng.normal(size=(6, 257)).astype(np.float32))
        c = torch.from_numpy(rng.uniform(0.1, 2.0, 6).astype(np.float32))
        full_u = torch.cat([torch.from_numpy(rng.normal(size=(4, 257)).astype(np.float32)), live])
        comp_u = torch.cat([live, torch.zeros(2, 257)])
        full_c = torch.cat([torch.zeros(4), c])
        comp_c = torch.cat([c, torch.zeros(2)])
        assert torch.equal(row_sum(full_c[:, None] * full_u), row_sum(comp_c[:, None] * comp_u))
        assert torch.equal(row_sum(full_c), row_sum(comp_c))
        m_full = torch.tensor([False] * 4 + [True] * 6)
        m_comp = torch.tensor([True] * 6 + [False] * 2)
        s = torch.from_numpy(rng.normal(size=6).astype(np.float32))
        s_full = torch.cat([torch.from_numpy(rng.normal(size=4).astype(np.float32)), s])
        s_comp = torch.cat([s, torch.zeros(2)])
        assert torch.equal(masked_mean(s_full, m_full), masked_mean(s_comp, m_comp))
        assert torch.equal(masked_std(s_full, m_full), masked_std(s_comp, m_comp))


# ------------------------- no host read in the round body -------------------


@pytest.mark.parametrize("rule,variant,scenario", [
    ("afa", "iterative", "byzantine"), ("afa", "gram", "byzantine"), ("afa", "gram", "alie"),
    ("fa", "iterative", "clean"), ("mkrum", "iterative", "ipm"),
    ("comed", "iterative", "flipping"), ("trimmed_mean", "iterative", "byzantine"),
])
def test_round_body_runs_on_meta(rule, variant, scenario):
    """A meta tensor has no data, so any bool(), .item(), .tolist() or
    nonzero in the round raises: the body that runs here has no host read
    that would break a CUDA graph's capture."""
    meta = torch.device("meta")
    K, S, b, n, D_in = 10, 2, 16, 40, 24
    wl = DnnWorkload((D_in, 16, 8, 10))
    server = ServerConfig(rule=rule, num_clients=K, afa_variant=variant)
    _, round_fn = make_fused_sim(
        wl, EngineConfig(scenario=scenario), rule=rule, opts=make_rule_options(server, K),
        delta_block=0.95, num_clients=K, num_rounds=8, batch_s=S, batch_b=b,
        bad_mask=np.arange(K) < 3, device=meta)
    params = {k: torch.empty(v.shape, device=meta)
              for k, v in wl.init_params(torch.Generator(), "cpu").items()}
    state = ServerState(
        ReputationState(torch.empty(K, device=meta), torch.empty(K, device=meta),
                        torch.empty(K, dtype=torch.bool, device=meta)),
        torch.empty(K, dtype=torch.int32, device=meta),
        torch.empty((), dtype=torch.int32, device=meta))
    i64 = dict(dtype=torch.int64, device=meta)
    data = FusedData(torch.empty((K, n, D_in), device=meta), torch.empty((K, n), **i64),
                     torch.empty(K, **i64), torch.empty(K, device=meta),
                     torch.empty((30, D_in), device=meta), torch.empty(30, **i64))
    (p, s), out = round_fn((params, state), torch.empty((), **i64), torch.empty((), **i64), data)
    assert out.test_error.shape == () and out.good_mask.shape == (K,)
    assert out.blocked.shape == (K,) and s.round.dtype == torch.int32
    assert all(v.device.type == "meta" for v in p.values())
