"""The yardstick's arithmetic on hand-counted cases."""
import pytest

from harness import yardstick as y
from reference import sgns_steps


def test_applier_bytes_hand_counted():
    # 10 entries naming 4 rows of a bf16 [*, 8] table: ids 40 B, payload
    # 10*8*4 = 320 B, rows read and written 2*4*8*2 = 128 B
    assert y.applier_bytes(10, 4, 8, 2) == 40 + 320 + 128


def test_least_time_takes_the_larger_term():
    t, bound = y.least_time(67e12, 0.0, y.H100_PEAKS["fp32_flops"])
    assert t == pytest.approx(1.0) and bound == "flops"
    t, bound = y.least_time(1.0, 3.35e12, 1e15)
    assert t == pytest.approx(1.0) and bound == "bytes"


def test_window_pairs_hand_counted():
    # 3 tokens, window 1: pairs (0,1), (1,0), (1,2), (2,1), each reached
    # with probability 1
    assert y.window_pairs(3, 1) == pytest.approx(4.0)
    # 2 tokens, window 2: offset 1 always (2 pairs), offset 2 out of range
    assert y.window_pairs(2, 2) == pytest.approx(2.0)
    # 3 tokens, window 2: offset 1: 4 pairs at 1; offset 2: (0,2), (2,0) at 1/2
    assert y.window_pairs(3, 2) == pytest.approx(5.0)


def test_sgns_step_least_hand_counted():
    # 2 walks of 3 tokens, window 1, 1 negative, dim 4: pairs 8, tokens 6;
    # FLOPs 6*4*(8 + 6) = 336; bytes 6*4 + 2*5*4*2 = 104
    t, bound = y.sgns_step_least(2, 3, 1, 1, 4, 5, 2)
    assert bound == "bytes" and t == pytest.approx(104 / 3.35e12)


def test_trial_bytes_lower_bounds():
    assert y.trial_propose_bytes(1, 2) == 4 + 32 + 12 + 16 + 64
    assert y.trial_accept_bytes(1, 2) == 24 + 13 + 64


def test_tokens_and_steps_of_the_entries():
    cfg = dict(num_walks=2, walk_length=80, dim=128, window_size=10, epochs=1,
               table_dtype="auto")

    class Mode:
        num_nodes = 1_000_000

    from harness import entries

    assert entries.EmbedEntry(Mode, cfg, {}).work() == 162_000_000
    assert entries.WalksEntry(Mode, cfg, {}).work() == 160_000_000


def test_batch_walks_of_the_cells():
    assert sgns_steps.batch_walks(sgns_steps.Hyper(), 1_000_000, 81) == 1235


def test_walk_call_least_hand_counted():
    # 2 walks of 3 steps: the [2, 4] int32 matrix 32 B, 6 sectors 192 B
    t, bound = y.walk_call_least(2, 3)
    assert bound == "bytes" and t == pytest.approx(224 / 3.35e12)
