"""The yardstick's counts against brute force at tiny sizes: attended
pairs, model FLOPs, the attention call's least time, the traffic
generator's pools, the packing check and the trace's arithmetic."""

import numpy as np
import pytest
import torch

from portbench import correctness, roofline, trace, traffic
from portbench.reference import common

SEP, PAD = 50, 63
DATA = {"separator": SEP, "pad": PAD, "token_ids": [0, SEP]}


def brute_keys(x, sep):
    B, T = x.shape
    out = np.zeros((B, T), np.int64)
    for b in range(B):
        for t in range(T):
            start = 0
            for s in range(1, t + 1):
                if sep is not None and x[b, s - 1] == sep:
                    start = s
            out[b, t] = sum(1 for s in range(t + 1) if s >= start)
    return out


@pytest.mark.parametrize("sep", [SEP, None])
def test_keys_per_position_counts_attended_pairs(sep):
    rng = np.random.default_rng(0)
    x = rng.integers(45, 55, (3, 40))
    assert np.array_equal(roofline.keys_per_position(x, sep),
                          brute_keys(x, sep))


@pytest.mark.parametrize("sep", [SEP, None])
def test_reference_and_yardstick_agree_on_document_starts(sep):
    rng = np.random.default_rng(1)
    x = rng.integers(45, 55, (2, 33))
    got = common.doc_starts(torch.from_numpy(x), sep).numpy()
    assert np.array_equal(got, roofline.doc_starts(x, sep))


def test_model_flops_sums_tokens_one_by_one():
    rng = np.random.default_rng(2)
    keys = rng.integers(1, 100, (2, 8))
    w = rng.random((2, 8)) < 0.7
    n_matmul, L, H, hd = 1000, 3, 4, 16
    want = sum(6 * n_matmul + 12 * L * H * hd * k
               for k, on in zip(keys.ravel(), w.ravel()) if on)
    assert roofline.model_flops(keys, w, n_matmul, L, H, hd) == want


def brute_bytes(B, T, H, Hkv, hd, elem, packed):
    """Every tensor the attention call must move once, by its shape."""
    moved = {"q": (B, T, H, hd), "o": (B, T, H, hd), "do": (B, T, H, hd),
             "dq": (B, T, H, hd), "k": (B, T, Hkv, hd),
             "v": (B, T, Hkv, hd), "dk": (B, T, Hkv, hd),
             "dv": (B, T, Hkv, hd)}
    n = sum(int(np.prod(s)) * elem for s in moved.values())
    n += 2 * B * H * T * 4                 # lse and delta, float32
    return n + (B * T * 4 if packed else 0)


@pytest.mark.parametrize("H,Hkv", [(16, 8), (12, 12), (4, 1)])
def test_attention_least_time_is_the_larger_bound(H, Hkv):
    B, T, hd = 4, 4096, 128
    pairs = B * T * (T + 1) // 2
    t = roofline.attention_least_seconds(pairs, B, T, H, Hkv, hd,
                                         packed=True)
    flops = 14 * hd * pairs * H
    assert t == pytest.approx(flops / 989e12)
    assert brute_bytes(B, T, H, Hkv, hd, 2, True) / 3.35e12 < t
    tiny = roofline.attention_least_seconds(8, 1, 8, H, Hkv, 64,
                                            packed=False)
    assert tiny == pytest.approx(brute_bytes(1, 8, H, Hkv, 64, 2, False)
                                 / 3.35e12)
    f32 = roofline.attention_least_seconds(8, 2, 8, H, Hkv, 64, True,
                                           "float32")
    assert f32 == pytest.approx(brute_bytes(2, 8, H, Hkv, 64, 4, True)
                                / 3.35e12)


def pack(docs, T, sep, pad):
    from neuralnetworklibrary_tpu_torch.data.packing import pack_documents

    return pack_documents(docs, T, sep, pad_token=pad)


MIX = {"rows": 2, "seq_len": 32, "pool_batches": 4,
       "doc_len": {"median": 6, "sigma": 1.0, "min": 1, "max": 31},
       "zipf": 1.1}


@pytest.mark.parametrize("arrange", ["pack", "stream"])
def test_pools_repeat_by_seed_and_keep_their_shapes(arrange):
    mix = dict(MIX, arrange=arrange)
    a = traffic.make(mix, DATA, 5, pack=pack)
    b = traffic.make(mix, DATA, 5, pack=pack)
    c = traffic.make(mix, DATA, 2 ** 31 + 9, pack=pack)
    assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])
    assert not np.array_equal(a["x"], c["x"])
    assert a["x"].shape == c["x"].shape == (8, 32)

    def shapes(p):  # each row's separator places, as a multiset
        return sorted(tuple(np.flatnonzero(r == SEP)) for r in p["y"])

    # each seed draws its own documents' lengths and places
    assert shapes(a) != shapes(c)
    assert np.all(a["x"][a["x"] != PAD] <= SEP)


def test_document_lengths_follow_the_mix_on_every_seed():
    d = {"median": 600, "sigma": 1.0, "min": 8, "max": 10 ** 6}
    mix = {"doc_len": d}
    want = np.exp(np.log(600) + 1.0 * np.array(
        [-0.6745, 0.0, 0.6745]))        # the log-normal's quartiles
    draws = [traffic.doc_lengths(np.random.default_rng(s), mix, 400_000)
             for s in (1, 2, 2 ** 31 + 3)]
    assert draws[0] != draws[1]
    for lengths in draws:
        assert sum(lengths) + len(lengths) >= 400_000
        got = np.quantile(lengths, [0.25, 0.5, 0.75])
        assert np.allclose(got, want, rtol=0.02)


def test_packing_check_finds_a_lost_or_broken_document():
    mix = dict(MIX, arrange="pack")
    p = traffic.make(mix, DATA, 7, pack=pack)
    x, y = p["packed"]
    assert correctness.packing_faults(p["docs"], x, y, SEP, PAD) == 0
    assert correctness.packing_faults(p["docs"][1:], x, y, SEP, PAD) > 0
    y2 = y.copy()
    y2[0, 3] = (y2[0, 3] + 1) % SEP
    assert correctness.packing_faults(p["docs"], x, y2, SEP, PAD) > 0


def test_trace_union_gaps_and_shares():
    device = [("k1", 0.0, 1.0), ("copy_k", 0.5, 2.0), ("k2", 3.0, 4.0),
              ("Memcpy HtoD", 4.0, 4.5), ("k1", 6.0, 7.0)]
    host = [("step", -1.0, 8.0), ("aten::item", 2.1, 2.9),
            ("cudaLaunchKernel", 4.6, 5.9)]
    red = trace.reduce(device, host)
    assert red["span_s"] == 7.0 and red["busy_s"] == 4.5
    assert red["breakdown"]["idle_gaps"] == [["aten::item", 1.0],
                                             ["cudaLaunchKernel", 1.5]][::-1]
    assert red["breakdown"]["device_ops"][0] == ["k1", 2.0]
    assert trace.seconds_of(device, ("copy",)) == 1.5
    assert trace.seconds_of(device, ("k",)) == 4.5
    assert trace.reduce([], host) == {"span_s": 0.0, "busy_s": 0.0,
                                      "breakdown": None}


def test_numbers_read_gaps_by_the_worst_leaf():
    ref = {"losses": [2.0, 1.0], "grad_sq": {"a": 25.0, "b": 4.0,
                                             "c": 1e-12},
           "change_sq": {"a": 1.0, "b": 4.0, "c": 1.0}}
    prog = {"losses": [2.0, 1.1], "grad_sq": {"a": 25.0, "b": 9.0,
                                              "c": 1e-12},
            "change_sq": {"a": 1.0, "b": 4.0, "c": 100.0}}
    values, where = correctness.numbers(prog, ref)
    assert values["loss_gap"] == pytest.approx(0.1)
    assert values["grad_gap"] == pytest.approx(0.5)   # b: |3 - 2| / 2
    assert where["grad_gap"] == "b"
    assert values["change_gap"] == 0.0   # c's gradient is nought: left out
    assert not correctness.judge(values, {"loss_gap": 0.05, "grad_gap": 1,
                                          "change_gap": 1})
    assert correctness.judge(values, {"loss_gap": 0.2, "grad_gap": 1,
                                      "change_gap": 1})
