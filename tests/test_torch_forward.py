"""The port's full forward on the CPU against the JAX package: attention
(out and lse) against ``flash_attention_pallas`` in interpret mode, the
teacher-forced ``forward`` of the dense, ssm and hybrid LMs against
``repro.models.lm.forward``, and the ``--check`` helper and CLI.  Inputs
are made from seeds with numpy; both sides compute in IEEE f32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import checks as jax_checks  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import checks  # noqa: E402

from torch_parity import jax_params  # noqa: E402

# the Pallas kernel (interpret mode) and the plain version both run IEEE
# f32; they differ in summation order and in the online softmax's rescaling
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["qwen2.5-3b-smoke", "mamba2-2.7b-smoke", "zamba2-2.7b-smoke"]
# whole-model comparisons: max |port - JAX| <= FWD_TOL of max(1, max |JAX|).
# Fed the same input, a Mamba block agrees to 1e-6 of its output's scale;
# through 4 layers the residual stream grows to |7| and the softplus step
# and the exp decays amplify the summation-order differences, so the ssm
# smoke model's logits land 5e-5 of their scale apart.
FWD_TOL = 1e-4


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= FWD_TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("hq,hkv,causal,window", [
    (4, 2, True, None),       # GQA, causal
    (2, 2, True, None),       # G = 1 (zamba2's shared block)
    (4, 1, True, 7),          # windowed
    (4, 2, False, None),      # not causal
    (2, 2, False, 5),         # window without causality
])
def test_attention_matches_flash_pallas(hq, hkv, causal, window):
    """out and lse against the Pallas forward at 37 tokens (a ragged key
    and query block), head dim 16."""
    rng = np.random.default_rng(hq * 10 + hkv + (window or 0))
    q = rng.standard_normal((2, 37, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, hkv, 16)).astype(np.float32)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window)
    jout, jlse = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                        causal=causal, window=window,
                                        interpret=True)
    assert out.shape == q.shape and lse.shape == (2, hq, 37)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **ATTN_TOL)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window)
    assert torch.equal(got, out)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Hidden states and logits of the teacher-forced forward over 24
    tokens, which crosses the smoke SSD chunk of 16 (``FWD_TOL``)."""
    jcfg, tree, jparams = jax_params(arch=arch, seed=4)
    cfg = get_arch(arch)
    params = params_from_jax(tree, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(jax_lm.forward, static_argnums=0,
                   static_argnames="remat")(jcfg, jparams, jnp.asarray(toks),
                                            remat=False)
    got = build_model(cfg, device="cpu").forward(
        params, torch.from_numpy(toks).long())
    assert got.shape == (2, 24, cfg.d_model)
    want_l = np.asarray(jax_lm.lm_logits(jcfg, jparams, want))
    got_l = lm.lm_logits(cfg, params, got).numpy()
    _close(got.numpy(), want, "hidden")
    _close(got_l, want_l, "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_check_helper_matches_jax(arch):
    """The teacher-forced logits of ``serving.checks`` against JAX's helper
    (``FWD_TOL``), and the port's decode path passes the check within
    JAX's 2e-2 (decode itself is held against JAX's step by step in
    test_torch_model.py and test_torch_ssm.py)."""
    jcfg, tree, jparams = jax_params(arch=arch, seed=5)
    cfg = get_arch(arch)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, device="cpu")
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jmodel = jax_build_model(jcfg)
    want = jax_checks.teacher_forced_logits(jmodel, jparams,
                                            jnp.asarray(prompt))
    got = checks.teacher_forced_logits(model, params,
                                       torch.from_numpy(prompt).long())
    _close(got.numpy(), want, "teacher-forced logits")
    err, scale = checks.assert_decode_matches_teacher_forced(
        model, params, torch.from_numpy(prompt).long(), 24)
    assert err <= 2e-2 and scale > 0


def test_check_catches_a_broken_decode_path():
    """A decode path that drops the recurrent carry disagrees with the
    forward, and the helper says so."""
    cfg = get_arch("mamba2-2.7b-smoke")
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))

    class Forgetful:
        def __getattr__(self, name):
            return getattr(model, name)

        def decode_step(self, params, state, token, **kw):
            state = {**state, "ssm": torch.zeros_like(state["ssm"])}
            return model.decode_step(params, state, token, **kw)

    with pytest.raises(AssertionError):
        checks.assert_decode_matches_teacher_forced(Forgetful(), params,
                                                    prompt, 16)


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-2.7b-smoke", []),
    ("zamba2-2.7b-smoke", ["--layout", "paged", "--prefill-chunk", "4"]),
])
def test_serve_cli_check(arch, extra, capsys):
    assert serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--prompt-len", "8", "--gen", "6", "--check",
                       *extra]) == 0
    assert "decode path matches teacher-forced forward" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_serve_cli_check_refuses_bf16_mamba_stacks(arch, capsys):
    """``--check`` on a full-depth bf16 Mamba arch is refused before any
    weight is made: no tolerance holds a random chaotic stack in bf16."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", arch, "--check"])
    assert "cannot hold" in capsys.readouterr().err
