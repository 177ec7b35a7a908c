"""The port's host-side pieces of packed decoder pretraining against the
JAX package on the CPU: RoPE (``nn.transformer.rope`` and
``rope_scaling_tuple``, every scaling variant and partial rotary),
``data.packing.pack_documents``, ``ops.chunked_ce`` (forward and both
gradients) and ``utils.safetensors_io``.

Tolerances: rope_scaling_tuple and pack_documents are exact (the same
host arithmetic); rope 1e-6 (float32 cos/sin of the same angles in two
libraries); the chunked CE 1e-5 relative for the loss and 1e-5 of the
largest entry for the gradients (float32 sums in other orders), and
against the port's dense yardstick the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.data.packing import (
    pack_documents as jax_pack,
)
from neuralnetworklibrary_tpu.nn import transformer as jtr
from neuralnetworklibrary_tpu.ops import chunked_ce as jce
from neuralnetworklibrary_tpu.utils import safetensors_io as jst
from neuralnetworklibrary_tpu_torch.data.packing import pack_documents
from neuralnetworklibrary_tpu_torch.nn import transformer as tr
from neuralnetworklibrary_tpu_torch.ops import chunked_ce as ce
from neuralnetworklibrary_tpu_torch.utils import safetensors_io as st

HD = 32
CONFIGS = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    "yarn": {"rope_type": "yarn", "factor": 8.0,
             "original_max_position_embeddings": 64},
    "yarn_mscale": {"type": "yarn", "factor": 4.0, "mscale": 0.7,
                    "mscale_all_dim": 0.5, "beta_fast": 16,
                    "truncate": False},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 32},
    "longrope": {"rope_type": "longrope"},
}


def _cfg(name, dim):
    """The config, longrope's factors sized for a rotary width ``dim``."""
    cfg = CONFIGS[name]
    if name == "longrope":
        cfg = dict(cfg, short_factor=list(np.linspace(1.0, 2.0, dim // 2)),
                   long_factor=list(np.linspace(1.0, 8.0, dim // 2)))
    return cfg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rope_scaling_tuple_matches_jax(name):
    cfg = _cfg(name, HD)
    want = jtr.rope_scaling_tuple(cfg, HD, 1e4, 128, original_max=64)
    assert tr.rope_scaling_tuple(cfg, HD, 1e4, 128, original_max=64) == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("per_row, rotary_dim", [(False, 0), (True, 0),
                                                 (False, 16)])
def test_rope_matches_jax(name, per_row, rotary_dim):
    """Full and partial rotary, shared (T,) and per-row (B, T) positions;
    longrope switches regime per row where the rows' positions straddle
    its 64-token boundary."""
    rng = np.random.default_rng(0)
    dim = rotary_dim or HD
    scaling = jtr.rope_scaling_tuple(_cfg(name, dim), dim, 1e4, 128,
                                     original_max=64)
    x = rng.standard_normal((2, 40, 3, HD)).astype(np.float32)
    pos = (np.stack([np.arange(40), np.arange(40) + 50]) if per_row
           else np.arange(40) + 30).astype(np.int32)
    want = jtr.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, scaling,
                    rotary_dim)
    got = tr.rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1e4,
                  scaling, rotary_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_pack_documents_matches_jax():
    rng = np.random.default_rng(1)
    docs = [rng.integers(2, 50, n).tolist() for n in
            rng.integers(1, 30, 40)]
    for pad in (None, 1):
        got = pack_documents(docs, 32, 0, pad_token=pad)
        want = jax_pack(docs, 32, 0, pad_token=pad)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]
    with pytest.raises(ValueError, match="exceeds the row capacity"):
        pack_documents([list(range(40))], 32, 0)


@pytest.mark.parametrize("chunk, masked", [(16, False), (24, True)])
def test_chunked_ce_matches_jax_and_dense(chunk, masked):
    """Loss, dh and demb of the port's chunked CE against the JAX
    package's (V 100, a last chunk that is short) and against the port's
    dense yardstick."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 9, 16)).astype(np.float32)
    emb = (rng.standard_normal((100, 16)) * 0.3).astype(np.float32)
    tgt = rng.integers(0, 100, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.7).astype(np.float32) if masked else \
        np.ones((2, 9), np.float32)
    jl, (jdh, jde) = jax.jit(jax.value_and_grad(
        lambda a, b: jce.chunked_softmax_ce(a, b, tgt, mask, chunk),
        argnums=(0, 1)))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tm = torch.from_numpy(mask) if masked else None
    loss = ce.chunked_softmax_ce(th, te, torch.from_numpy(tgt), tm, chunk)
    dh, de = torch.autograd.grad(loss, (th, te))
    dense = ce.dense_softmax_ce(th, te, torch.from_numpy(tgt), tm)
    ddh, dde = torch.autograd.grad(dense, (th, te))
    for got in ((loss, dh, de), (dense, ddh, dde)):
        np.testing.assert_allclose(float(got[0].detach()), float(jl), rtol=1e-5)
        for g, w in zip(got[1:], (jdh, jde)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_safetensors_round_trip_and_jax_files(tmp_path):
    """The port's writer and reader round-trip every dtype (bf16 widened
    on read), and read what the JAX package's writer wrote, and a
    sharded index."""
    rng = np.random.default_rng(3)
    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.integers(-5, 5, (7,)).astype(np.int64),
               "c": np.arange(6, dtype=np.int8).reshape(2, 3)}
    st.save_safetensors(tensors, str(tmp_path / "p.safetensors"),
                        metadata={"format": "np"})
    jst.save_safetensors(tensors, str(tmp_path / "j.safetensors"))
    for name in ("p", "j"):
        got = st.load_safetensors(str(tmp_path / f"{name}.safetensors"))
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == v.dtype
    bf = torch.randn(5, 3).to(torch.bfloat16)
    import json
    import struct
    raw = bf.view(torch.int16).numpy().tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [5, 3],
                               "data_offsets": [0, len(raw)]}}).encode()
    with open(tmp_path / "bf.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + raw)
    np.testing.assert_array_equal(
        st.load_safetensors(str(tmp_path / "bf.safetensors"))["w"],
        bf.float().numpy())
    shard = tmp_path / "shards"
    shard.mkdir()
    st.save_safetensors({"a": tensors["a"]}, str(shard / "m-1.safetensors"))
    st.save_safetensors({"b": tensors["b"]}, str(shard / "m-2.safetensors"))
    (shard / "m.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {"a": "m-1.safetensors", "b": "m-2.safetensors"}}))
    got = st.load_safetensors_auto(str(shard))
    assert sorted(got) == ["a", "b"]
    np.testing.assert_array_equal(got["b"], tensors["b"])
