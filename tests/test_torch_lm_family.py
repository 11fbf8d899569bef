"""The LM family beyond d512 on the host: the fused head's plain versions at
the new kernel widths against the JAX package's Pallas kernels (interpret
mode), and the entry points ``lm1b_train``, ``scale_lm`` and ``run_all``'s
``lm1b_lstm`` row at tiny shapes.

The fused head runs f32 on both sides (lm1b's LSTM hands it f32 h), so the
tolerances are ``tests/test_torch_fused_xent.py``'s: 1e-5 for the lse,
rtol 2e-4 / atol 2e-5 for the gradients. The entry points are held to the
JAX scripts' flags, defaults and printed lines; their models are held to the
JAX package in ``tests/test_torch_lstm_lm.py`` and
``tests/test_torch_transformer_lm.py``.
"""

import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import transformer_lm as jlm
from autodist_tpu.ops import fused_xent as jfx
from autodist_tpu_torch.examples import scale_lm
from autodist_tpu_torch.examples.benchmark import run_all
from autodist_tpu_torch.examples.lm1b import lm1b_train
from autodist_tpu_torch.ops import fused_xent as tfx

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
TINY = ["--device", "cpu", "--batch_size", "4", "--seq_len", "8", "--d_model", "16",
        "--n_layers", "1", "--vocab", "128", "--steps", "2", "--log_every", "1"]


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("layout,bias", [("dv", False), ("vd", True)])
def test_fused_head_plain_versions_match_jax_at_the_new_widths(d, layout, bias):
    """lse and its gradients in h, w and b, f32 h, N and V off every tile."""
    rng = np.random.RandomState(d)
    n, v = 33, 131
    h = (rng.randn(n, d) * 0.5).astype(np.float32)
    w = (rng.randn(d, v) * 0.05).astype(np.float32)
    w = np.ascontiguousarray(w.T) if layout == "vd" else w
    b = (rng.randn(v) * 0.1).astype(np.float32) if bias else None
    coef = rng.rand(n).astype(np.float32)
    args = [jnp.asarray(x) for x in (h, w, b) if x is not None]

    def jloss(*a):
        hh, ww = a[0], a[1]
        bb = a[2] if bias else None
        return jnp.sum(jfx.matmul_logsumexp(hh, ww, bb, jfx.DEFAULT_N_BLOCK,
                                            jfx.DEFAULT_V_BLOCK, None, layout) * coef)

    want_lse = jfx.matmul_logsumexp(args[0], args[1], args[2] if bias else None,
                                    jfx.DEFAULT_N_BLOCK, jfx.DEFAULT_V_BLOCK, None, layout)
    want_grads = jax.grad(jloss, tuple(range(len(args))))(*args)
    ts = [torch.tensor(x, requires_grad=True) for x in (h, w, b) if x is not None]
    lse = tfx.matmul_logsumexp(ts[0], ts[1], ts[2] if bias else None, w_layout=layout)
    (lse * torch.as_tensor(coef)).sum().backward()
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse), **VAL)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)


def test_kernel_widths_and_the_f32_rounding():
    """The instantiated widths; another raises naming the ROADMAP item (the
    check the wrappers make before any launch on the card); an f32 h is
    rounded to bf16 for the kernels once, a bf16 one passed as it is."""
    assert tfx.KERNEL_WIDTHS == (512, 768, 1024)
    for d in tfx.KERNEL_WIDTHS:
        tfx._check_width(d)
    with pytest.raises(ValueError, match="Queue 2 item 1"):
        tfx._check_width(640)
    h = torch.randn(3, 768)
    assert tfx.kernel_h(h).dtype == torch.bfloat16
    assert torch.equal(tfx.kernel_h(h), h.to(torch.bfloat16))
    hb = h.to(torch.bfloat16)
    assert tfx.kernel_h(hb) is hb


def _lm1b(argv, capsys):
    rate = lm1b_train.main(argv)
    return rate, capsys.readouterr().out


@pytest.mark.parametrize("extra,mfu", [(["--model", "lstm"], True),
                                       (["--model", "lstm", "--full_softmax"], False),
                                       (["--model", "transformer"], True)])
def test_lm1b_train_tiny(extra, mfu, capsys):
    """Each model trains and prints the JAX script's lines: the optimizer
    choice, the final loss and words/sec, and (not for --full_softmax) the
    MFU line, which on the host says it is not measured."""
    rate, out = _lm1b(TINY + extra, capsys)
    assert rate > 0
    assert "optimizer: adam" in out
    final = [line for line in out.splitlines() if line.startswith("final loss ")]
    assert len(final) == 1 and "words/sec" in final[0]
    assert np.isfinite(float(final[0].split()[2].rstrip(";")))
    assert ("mfu not measured" in out) == mfu


def test_lm1b_defaults_match_the_jax_script():
    args = lm1b_train.parse_args([])
    assert (args.model, args.steps, args.batch_size, args.seq_len, args.log_every,
            args.d_model, args.n_layers, args.vocab) == \
        ("transformer", 200, 0, 256, 100, 512, 6, 32000)
    cfg, params, _ = lm1b_train.build_model(
        argparse.Namespace(model="lstm", vocab=128, d_model=16, n_layers=2,
                           full_softmax=True), torch.device("cpu"))
    assert (cfg.emb_dim, cfg.hidden_dim, cfg.n_layers, cfg.num_sampled) == (16, 32, 2, 1024)
    assert params["softmax_w"].shape == (128, 32) and cfg.dtype == torch.float32
    with pytest.raises(SystemExit):
        lm1b_train.parse_args(["--model", "transformer", "--full_softmax"])


def test_lm1b_corpus_then_data_dir(tmp_path, capsys):
    """--write_synthetic_corpus writes shards and the sidecar; --data_dir
    trains from them through the loader and the device feed; the JAX
    script's checks refuse the sampled path, a wrong width and a larger
    corpus vocabulary."""
    data = str(tmp_path / "corpus")
    lm1b_train.main(["--write_synthetic_corpus", "64", "--data_dir", data, "--seq_len", "8",
                     "--vocab", "128"])
    assert len(glob.glob(os.path.join(data, "tokens-*.npy"))) == 8
    assert os.path.exists(os.path.join(data, "tokens-meta.json"))
    rate, out = _lm1b(TINY + ["--model", "lstm", "--full_softmax", "--data_dir", data],
                      capsys)
    assert rate > 0 and "final loss" in out
    for bad in (["--model", "lstm"], ["--model", "lstm", "--full_softmax", "--seq_len", "4"]):
        with pytest.raises(SystemExit):
            lm1b_train.main(TINY + bad + ["--data_dir", data])
    small = TINY[:TINY.index("--vocab")] + ["--vocab", "64"] + TINY[TINY.index("--vocab") + 2:]
    with pytest.raises(SystemExit):
        lm1b_train.main(small + ["--model", "transformer", "--data_dir", data])


def test_lm1b_tokenize_corpus(tmp_path, capsys):
    text = tmp_path / "news.txt"
    text.write_text("the cat sat on the mat\nthe dog sat on the log\n" * 8)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("the 10\nsat 5\non 5\ncat 2\n")
    data = str(tmp_path / "tok")
    lm1b_train.main(["--tokenize_corpus", str(text), "--vocab_file", str(vocab),
                     "--data_dir", data, "--seq_len", "4", "--vocab", "64"])
    out = capsys.readouterr().out
    assert "tokenized corpus" in out and "--vocab 5" in out
    shard = np.load(sorted(glob.glob(os.path.join(data, "tokens-*.npy")))[0])
    assert shard.dtype == np.int32 and shard.shape[1] == 5 and shard.max() < 5


def test_scale_lm_at_the_jax_test_shape(capsys):
    """tests/test_scale_lm_example.py's shape; the model is the JAX
    script's (n_heads = d / 64, d_ff = 4 d, max_len = seq_len, untied) with
    the plain head on the host."""
    argv = ["--device", "cpu", "--d_model", "64", "--n_layers", "2", "--batch_size", "8",
            "--seq_len", "64", "--vocab", "256", "--steps", "2"]
    rate = scale_lm.main(argv)
    out = capsys.readouterr().out
    assert rate > 0
    assert "d64x2 bs8 seq64" in out and "tokens/sec" in out
    cfg, _, _ = scale_lm.build(scale_lm.parse_args(argv))
    want = jlm.TransformerLMConfig(vocab_size=256, d_model=64, n_heads=1, n_layers=2,
                                   d_ff=256, max_len=64, tied_output=False)
    for field in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len",
                  "tied_output", "remat", "fused_head"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_run_all_lm1b_lstm_row():
    assert run_all.not_ported("lm1b_lstm") is None
    argv = run_all.CONFIGS["lm1b_lstm"][0]("5")
    assert argv[:2] == ["-m", "autodist_tpu_torch.examples.lm1b.lm1b_train"]
    assert argv[argv.index("--model") + 1] == "lstm"
    canned = ("step 5: 98765.4 words/sec\nfinal loss 9.8765; average 123,456.7 words/sec\n"
              "mfu 12.34% (122.0 TFLOP/s, 100.00 GFLOP/step)\n")
    row = run_all.parse_output("lm1b_lstm", canned)
    assert row == {"name": "lm1b_lstm", "unit": "words/s", "rate": 123456.7,
                   "mfu_pct": 12.34, "error": None}
