"""The packed modern decoder (Qwen3 / Llama shape) of the port against the
JAX package on the CPU: a 2-layer TransformerLM at d_model 64 with 4 heads
of head_dim 32 over 2 kv heads (4 * 32 != 64), rotary phases, q/k norms,
SwiGLU, RMSNorm and reset_at packing; its logits, packed loss and every
gradient on both attention paths; packed against standalone documents;
remat; a short packed Learner run; the fused and packed losses; and the
Llama / Qwen3 converters against HF models built from config objects (no
download) and against the JAX converter.

Tolerances: logits 1e-5 and gradients 1e-5 of their largest entry
(float32 sums in other orders; 2 layers); packed against standalone 1e-5;
remat against no remat exact (the same operations replayed, the flash
dropout seeds drawn before the blocks); the Learner's per-step losses
rtol 1e-5; HF logits 1e-4 relative to their largest entry (float32 torch
on both sides, other op orders); converted parameters exact.
"""

import functools
import json
import os
import tempfile
import types

os.environ.setdefault("USE_TF", "0")   # transformers without TensorFlow

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

from neuralnetworklibrary_tpu.applications import text as jtext  # noqa: E402
from neuralnetworklibrary_tpu.data import loader as jax_loader  # noqa: E402
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner  # noqa
from neuralnetworklibrary_tpu.nn import transformer as jtr  # noqa: E402
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh  # noqa: E402
from neuralnetworklibrary_tpu.utils import llama_convert as jconv  # noqa
from neuralnetworklibrary_tpu_torch.applications import text  # noqa: E402
from neuralnetworklibrary_tpu_torch.data import loader  # noqa: E402
from neuralnetworklibrary_tpu_torch.data.packing import (  # noqa: E402
    pack_documents,
)
from neuralnetworklibrary_tpu_torch.learner import Learner  # noqa: E402
from neuralnetworklibrary_tpu_torch.nn import transformer as tr  # noqa
from neuralnetworklibrary_tpu_torch.utils import llama_convert as conv  # noqa
from neuralnetworklibrary_tpu_torch.utils.jax_params import (  # noqa: E402
    _flatten,
    _torch_name,
    load_jax_params,
)

V, EOS, PAD, T = 50, 0, 1, 64
CFG = dict(vocab_size=V, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
           n_layers=2, d_ff=96, max_len=T, drop=0.0, pos_embedding="rope",
           rope_base=1e4, qk_norm=True, mlp="swiglu", norm="rmsnorm",
           reset_at=EOS)


@functools.cache
def _params():
    """The JAX model's params with every leaf moved off its init (norm
    scales away from 1, biases away from 0), as numpy."""
    jm = jtr.TransformerLM(**CFG, flash_attention=False)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), p["params"])


@functools.cache
def _rows(n=4, seed=1):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(2, V, k).tolist()
            for k in rng.integers(1, 30, 6 * n)]
    x, y, _ = pack_documents(docs, T, EOS, pad_token=PAD)
    return x[:n], y[:n]


def _port(**kw):
    return load_jax_params(tr.TransformerLM(**{**CFG, **kw}, device="cpu"),
                           _params())


def _close(got, want, name="", scale=None):
    want = np.asarray(want)
    atol = 1e-5 * (np.abs(want).max() if scale is None else scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=max(atol, 1e-7), err_msg=name)


@functools.cache
def _jax_loss_and_grads():
    """The JAX model's (einsum path) packed loss, logits and gradients."""
    x, y = _rows()
    jm = jtr.TransformerLM(**CFG, flash_attention=False)
    jloss_fn = jtr.PackedSeqCrossEntropyLoss(PAD)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jloss_fn(out, jnp.asarray(y)), out[0]

    return jax.jit(jax.value_and_grad(jloss, has_aux=True))(_params())


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_jax(flash):
    """Both attention paths (einsum with the segment mask; the flash op
    with q_start, here its plain version) against the JAX model's einsum
    path: logits, PackedSeqCrossEntropyLoss and every gradient."""
    x, y = _rows()
    (jl, jlogits), jg = _jax_loss_and_grads()
    pm = _port(flash_attention=flash)
    out = pm(torch.from_numpy(x).long())
    loss = tr.PackedSeqCrossEntropyLoss(PAD)(out, torch.from_numpy(y))
    loss.backward()
    _close(out[0].detach(), jlogits, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    grads = dict(pm.named_parameters())
    flat = list(_flatten(jax.tree_util.tree_map(np.asarray, jg)))
    scale = max(np.abs(g).max() for _, g in flat)
    for name, g in flat:
        g = g.T if name.endswith(".kernel") else g
        _close(grads[_torch_name(name)].grad, g, name, scale)


def test_packed_matches_standalone_documents():
    """Each document's logits inside a packed row (flash path, q_start)
    equal its own forward, and a row without reset_at differs."""
    x, _ = _rows()
    pm = _port(flash_attention=True)
    row = torch.from_numpy(x[:1]).long()
    with torch.no_grad():
        packed = pm(row)[0][0]
        seg, pos = pm.packing(row)
        for s in torch.unique(seg[0]).tolist()[:4]:
            idx = (seg[0] == s).nonzero()[:, 0]
            a, b = int(idx[0]), int(idx[-1]) + 1
            _close(pm(row[:, a:b])[0][0], packed[a:b].numpy(), f"doc {s}")
        pm.reset_at = None
        assert not torch.allclose(pm(row)[0][0], packed, atol=1e-3)


def test_remat_replays_flash_dropout():
    """remat=True gives the gradients of remat=False bit for bit with
    dropout on (flash dropout hash seeds drawn once before each block,
    torch's RNG replayed by the checkpoint)."""
    x, y = _rows()
    grads = []
    for remat in (False, True):
        pm = _port(flash_attention=True, drop=0.1, remat=remat)
        torch.manual_seed(3)
        out = pm(torch.from_numpy(x).long(), train=True,
                 generator=torch.Generator().manual_seed(4))
        tr.PackedSeqCrossEntropyLoss(PAD)(out, torch.from_numpy(y)).backward()
        grads.append({n: p.grad for n, p in pm.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0)


def _data(ds_mod, dl_mod, x, y):
    ds = ds_mod(x, y)
    return types.SimpleNamespace(target_type="lang_model", bs=2,
                                 train_dl=dl_mod(ds, 2, prefetch=0),
                                 val_dl=dl_mod(ds, 2, prefetch=0))


def test_packed_learner_matches_jax():
    """fit_one_cycle over packed rows (ArrayDataset / DataLoader,
    PackedSeqCrossEntropyLoss): the port's Learner (flash path, q_start)
    against the JAX Learner (einsum path, segment mask) from the same
    weights: per-step losses and the final evaluation."""
    x, y = _rows(6, seed=2)
    jl = JaxLearner(tempfile.mkdtemp(),
                    _data(jax_loader.ArrayDataset, jax_loader.DataLoader,
                          x, y),
                    jtr.TransformerLM(**CFG, flash_attention=False),
                    "Adam2", loss_func=jtr.PackedSeqCrossEntropyLoss(PAD),
                    mesh=get_mesh(1), seed=0)
    pm = load_jax_params(tr.TransformerLM(**CFG, flash_attention=True,
                                          device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jl.params))
    pl = Learner(tempfile.mkdtemp(), _data(loader.ArrayDataset,
                                           loader.DataLoader, x, y),
                 pm, "Adam2", loss_func=tr.PackedSeqCrossEntropyLoss(PAD),
                 seed=0, device="cpu")
    jl.fit_one_cycle(5e-3, 1, wd=1e-4)
    pl.fit_one_cycle(5e-3, 1, wd=1e-4)
    want = np.asarray([float(v) for v in jl.loss_sched])
    got = np.asarray([float(v) for v in pl.loss_sched])
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(pl.evaluate("val")[0], jl.evaluate("val")[0],
                               rtol=1e-5)


def test_fused_and_packed_losses_match_jax():
    """FusedSeqCrossEntropyLoss on (h, head) with a (B,) row mask, and
    PackedSeqCrossEntropyLoss with pad targets and a row mask, against
    the JAX losses: values and the gradients of h and head."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 7, 16)).astype(np.float32)
    emb = rng.standard_normal((V, 16)).astype(np.float32) * 0.3
    tgt = rng.integers(0, V, (3, 7)).astype(np.int32)
    tgt[1, 4:] = PAD
    rows = np.asarray([1.0, 1.0, 0.0], np.float32)
    jf = jtr.FusedSeqCrossEntropyLoss(chunk=16)
    jv, jg = jax.jit(jax.value_and_grad(lambda a, b: jf((a, b), tgt, rows),
                                        argnums=(0, 1)))(h, emb)
    th, te = (torch.from_numpy(a).requires_grad_() for a in (h, emb))
    v = tr.FusedSeqCrossEntropyLoss(chunk=16)((th, te), torch.from_numpy(tgt),
                                              torch.from_numpy(rows))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    for g, w in zip(torch.autograd.grad(v, (th, te)), jg):
        _close(g, w)
    logits = rng.standard_normal((3, 7, V)).astype(np.float32)
    jp = jtr.PackedSeqCrossEntropyLoss(PAD)((jnp.asarray(logits), None),
                                            jnp.asarray(tgt),
                                            jnp.asarray(rows))
    p = tr.PackedSeqCrossEntropyLoss(PAD)((torch.from_numpy(logits), None),
                                          torch.from_numpy(tgt),
                                          torch.from_numpy(rows))
    np.testing.assert_allclose(float(p), float(jp), rtol=1e-6)


def test_fused_ce_lm_and_awd_lstm_losses():
    """TransformerLM(fused_ce=True) returns (h, head) whose fused loss is
    the materialised CE; LanguageModelNet(fused_ce=True) with
    FusedRegSeqCrossEntropyLoss equals the materialised
    RegSeqCrossEntropyLoss and the JAX FusedRegSeqCrossEntropyLoss on the
    same outputs, gradients included."""
    x, y = _rows()
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    pm = _port()
    ref = text.SeqCrossEntropyLoss()(pm(xt), yt)
    pm.fused_ce = True
    h, head = pm(xt)
    assert head is pm.word_embed
    fused = tr.FusedSeqCrossEntropyLoss(chunk=16)((h, head), yt)
    np.testing.assert_allclose(float(fused), float(ref), rtol=1e-6)

    torch.manual_seed(0)
    lm = text.LanguageModelNet(V, emb_dim=8, hidden_size=12, num_layers=2,
                               device="cpu")
    flm = text.LanguageModelNet(V, emb_dim=8, hidden_size=12, num_layers=2,
                                fused_ce=True, device="cpu")
    flm.load_state_dict(lm.state_dict())
    xs, ys = xt[:, :9], yt[:, :9]
    want = text.RegSeqCrossEntropyLoss(2.0, 1.0)(lm(xs), ys)
    gw = torch.autograd.grad(want, list(lm.parameters()))
    out = flm(xs)
    got = text.FusedRegSeqCrossEntropyLoss(2.0, 1.0, chunk=16)(out, ys)
    gg = torch.autograd.grad(got, list(flm.parameters()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for a, b in zip(gg, gw):
        _close(a, b.numpy())
    jv = jtext.FusedRegSeqCrossEntropyLoss(2.0, 1.0, chunk=16)(
        tuple(jnp.asarray(o.detach().numpy()) for o in out), jnp.asarray(y[:, :9]))
    np.testing.assert_allclose(float(got), float(jv), rtol=1e-6)


def _hf(kind, tie, seed):
    common = dict(vocab_size=V, hidden_size=64, intermediate_size=88,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=T,
                  tie_word_embeddings=tie, attention_dropout=0.0)
    cfg = (transformers.Qwen3Config(**common, head_dim=32, rms_norm_eps=1e-6,
                                    rope_theta=1e6)
           if kind == "qwen3" else
           transformers.LlamaConfig(**common, rms_norm_eps=1e-5,
                                    rope_theta=5e5))
    torch.manual_seed(seed)
    cls = (transformers.Qwen3ForCausalLM if kind == "qwen3"
           else transformers.LlamaForCausalLM)
    return cls(cfg).eval()


@pytest.mark.parametrize("kind, tie", [("qwen3", True), ("llama", False)])
def test_converters_match_hf_and_jax(kind, tie):
    """load_qwen3 / load_llama on an HF model built from its config: the
    port model's logits against HF's, and the flax tree against the JAX
    converter's, leaf for leaf."""
    hf = _hf(kind, tie, seed=1)
    sd = hf.state_dict()
    kw = dict(n_layers=2, n_heads=4, n_kv_heads=2, d_model=64, d_ff=88,
              vocab_size=V, max_len=T)
    if kind == "qwen3":
        kw.update(head_dim=32, rope_base=1e6, norm_eps=1e-6)
        model, params = conv.load_qwen3(sd, device="cpu", **kw)
        _, jparams = jconv.load_qwen3(sd, **kw)
    else:
        kw.update(rope_base=5e5, norm_eps=1e-5)
        model, params = conv.load_llama(sd, device="cpu", **kw)
        _, jparams = jconv.load_llama(sd, **kw)
    assert model.tied_decoder is tie
    jflat = dict(_flatten(jparams))
    flat = dict(_flatten(params))
    assert sorted(flat) == sorted(jflat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(arr, jflat[name], err_msg=name)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, V, (2, 17)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = model(x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_load_llama_dir_reads_a_saved_snapshot(tmp_path):
    """load_llama_dir on save_pretrained's directory (config.json and
    safetensors, read by the port's own reader) gives HF's logits; other
    model types raise NotImplementedError."""
    hf = _hf("qwen3", True, seed=3)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    model, _ = conv.load_llama_dir(str(tmp_path), device="cpu")
    assert model.head_dim == 32 and model.tied_decoder
    x = torch.from_numpy(np.random.default_rng(4).integers(0, V, (1, 20)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = model(x)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    cfg = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(
        dict(cfg, model_type="mixtral")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv.load_llama_dir(str(tmp_path), device="cpu")


@pytest.mark.parametrize("option", [
    dict(embed_scale=8.0), dict(window_pattern=(0, 4)),
    dict(attn_softcap=50.0), dict(logit_softcap=30.0), dict(att_scale=2.0),
    dict(post_norm=True), dict(parallel_block=True), dict(head_bias=True),
    dict(n_experts=4, capacity_factor=1.25), dict(lora_rank=4),
    dict(sp=True), dict(cp=True)])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.TransformerLM(**CFG, **option, device="cpu")
