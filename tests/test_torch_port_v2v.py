"""The port's video-to-video slice against the JAX package on the CPU:
``_latent_bilinear`` both ways, the EDM sampler family (every sampler, both
discretizations, the churn), ``VectorQuantizer`` and ``LFQ`` with their
straight-through gradients and ``VQVAE3D``, ``V2VEnhanceFlow``'s
conditioning latents, concat ``denoise_apply`` and degradation loss on the
narrow UNet of ``tests/test_torch_port_videocrafter.py``, the CLI
(``inference-v2v-ms`` and the enhancement model through ``cli/v2v``), and
queue 3's missing V2V input directory in both packages.  (The three
branches of ``GenerationFlow.enhance`` are held to JAX where each module
builds its flow: DDIM in ``test_torch_port_videocrafter.py``, CogVideoX's
DPM in ``test_torch_port_flow.py``, flow matching in
``test_torch_port_hunyuan.py``.)

Inputs and noise come from numpy or the JAX package's own keys; f32
throughout.  Tolerances, of max|ref|: 1e-5 for the resize, the samplers and
the quantisers, 1e-4 for the UNet and the loss, 1e-3 for decoded pixels."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.flows import v2v as jv2v
from videotuna_tpu.models import vq as JVQ
from videotuna_tpu.schedulers import edm as jedm
from videotuna_tpu_torch.cli import commands as pcommands
from videotuna_tpu_torch.cli import v2v as pcli
from videotuna_tpu_torch.flows import v2v as pv2v
from videotuna_tpu_torch.models import vq as PVQ
from videotuna_tpu_torch.schedulers import edm as pedm
from videotuna_tpu_torch.tools.from_jax import load_jax_params

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)
from tests.test_torch_port_opensora import _close, _t
from tests.test_torch_port_videocrafter import CONFIGS, NARROW, _flows

MODULE_TOL = 1e-5
UNET_TOL = 1e-4
V2V_MS = os.path.join(CONFIGS, "011_v2v", "v2v_ms.yaml")
V2V_UNET = os.path.join(CONFIGS, "011_v2v", "v2v_enhance_unet.yaml")


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("src,dst", [((8, 12), (16, 24)), ((16, 24), (8, 12)),
                                     ((9, 7), (5, 11))],
                         ids=["up2", "down2", "ragged"])
def test_latent_bilinear_matches_jax_image_resize(src, dst):
    """Upsampling (the latent ``upscale``), the 2× downscale of the
    training loss (antialiased in both) and a ragged mix."""
    z = np.random.default_rng(0).standard_normal((2, 3, *src, 4),
                                                 dtype=np.float32)
    ref = jax.jit(lambda x: jv2v._latent_bilinear(x, dst))(jnp.asarray(z))
    _close(pv2v._latent_bilinear(_t(z), dst), ref, MODULE_TOL)


# ---------------------------------------------------------------- EDM
def _denoiser(lib):
    def d(x, sigma):
        return x / (1.0 + sigma ** 2) + 0.05 * lib.sin(x) * sigma / (1.0
                                                                  + sigma)
    return d


@pytest.mark.parametrize("method,disc,kw", [
    ("euler", "karras", {}), ("euler", "ddpm", {"s_churn": 1.0}),
    ("heun", "karras", {}), ("euler_ancestral", "karras", {"eta": 1.0}),
    ("dpmpp2s_ancestral", "ddpm", {"eta": 0.7}), ("dpmpp2m", "karras", {}),
    ("lms", "ddpm", {})], ids=lambda v: str(v) if not isinstance(v, dict)
    else "-".join(v) or "plain")
def test_edm_sampler_matches_jax(method, disc, kw):
    """Each sampler over 6 sigmas; the stochastic ones take the noises the
    JAX key draws step by step."""
    n = 6
    jfam = jedm.EDMSamplerFamily.create(n, disc)
    pfam = pedm.EDMSamplerFamily.create(n, disc)
    _close(pfam.sigmas, jfam.sigmas, 1e-6)
    x = np.random.default_rng(1).standard_normal((2, 3, 4),
                                                 dtype=np.float32) * 10
    key = jax.random.key(5)
    ref = jfam.sample(_denoiser(jnp), jnp.asarray(x), key, method=method,
                      **kw)
    if method in ("euler", "euler_ancestral", "dpmpp2s_ancestral"):
        kw = dict(kw, noises=_t(np.stack([
            np.asarray(jax.random.normal(k, x.shape))
            for k in jax.random.split(key, n)])))
    out = pfam.sample(_denoiser(torch), _t(x), None, method=method, **kw)
    _close(out, ref, MODULE_TOL)


def test_edm_registers_the_sgm_samplers():
    from videotuna_tpu_torch.core import registry as pregistry
    for name in ("EulerEDMSampler", "HeunEDMSampler", "DPMPP2MSampler",
                 "LinearMultistepSampler"):
        fam = pregistry.instantiate({
            "target": pedm._SGM + name,
            "params": {"num_steps": 4, "discretization": "ddpm",
                       "verbose": True}})
        assert isinstance(fam, pedm.EDMSamplerFamily) and fam.num_steps == 4


# ---------------------------------------------------------------- VQ
def _ste_grads_jax(jm, params, z, w):
    def loss(p, z):
        out, aux = jm.apply({"params": p}, z)
        return jnp.sum(out * w) + aux["vq_loss"], (out, aux)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(z))


@pytest.mark.parametrize("kind", ["vq", "lfq"])
def test_quantizers_and_straight_through_grads_match_jax(kind):
    """The quantised latents, the codes, the loss terms and the gradients
    of sum(out·w) + vq_loss to z (the straight-through path plus the
    commitment and entropy terms) and to the codebook."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 3, 4, 5, 6), dtype=np.float32) * 0.1
    w = rng.standard_normal(z.shape, dtype=np.float32)
    if kind == "vq":
        jm, pm = JVQ.VectorQuantizer(16, 6), PVQ.VectorQuantizer(16, 6)
        params = jax_params(jm, like=pm)
        load_jax_params(pm, params)
    else:
        jm, pm, params = JVQ.LFQ(dim=6), PVQ.LFQ(dim=6), {}
    (_, (jout, jaux)), (jgp, jgz) = _ste_grads_jax(jm, params, z, w)
    zt = _t(z).requires_grad_()
    out, aux = pm(zt)
    ((out * _t(w)).sum() + aux["vq_loss"]).backward()
    _close(out, jout, MODULE_TOL)
    np.testing.assert_array_equal(aux["indices"].numpy(),
                                  np.asarray(jaux["indices"]))
    for k in jaux:
        if k != "indices":
            np.testing.assert_allclose(float(aux[k].detach()),
                                       float(jaux[k]), rtol=1e-5, err_msg=k)
    _close(zt.grad, jgz, MODULE_TOL)
    if kind == "vq":
        _close(pm.codebook.grad, jgp["codebook"], MODULE_TOL)


@pytest.mark.parametrize("quantizer", ["vq", "lfq"])
def test_vqvae3d_matches_jax(quantizer):
    cfg = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_dim=4,
               quantizer=quantizer, codebook_size=16)
    jm, pm = JVQ.VQVAE3D(**cfg), PVQ.VQVAE3D(**cfg)
    params = jax_params(jm, like=pm)
    load_jax_params(pm, params)
    video = np.random.default_rng(3).uniform(
        -1, 1, (1, 5, 16, 16, 3)).astype(np.float32)
    jrecon, jaux = jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, jnp.asarray(video))
    with torch.no_grad():
        recon, aux = pm(_t(video))
    np.testing.assert_array_equal(aux["indices"].numpy(),
                                  np.asarray(jaux["indices"]))
    _close(recon, jrecon, UNET_TOL)


# ---------------------------------------------------------------- V2V flow
def _v2v():
    return _flows(V2V_UNET, NARROW)


def test_v2v_conditioning_matches_jax_and_uncond_is_zero_z_cond():
    """The conditioning latents with ``upscale`` 2 (a 64×64 clip's 8×8
    latents encoded, upsampled to 16×16 and augmented to t_aug at strength
    0.4, the JAX key's draws handed to the port); ``denoise_apply``
    without z_cond (CFG's unconditional stream) is the call with zero
    z_cond, as in the JAX flow (the concat call itself is held to JAX in
    the loss below)."""
    jflow, pflow, params = _v2v()
    assert pflow.denoiser.in_channels == 8
    rng = np.random.default_rng(4)
    video = rng.uniform(-1, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    key = jax.random.key(9)
    k_enc, k_aug = jax.random.split(key)
    jflow.upscale = pflow.upscale = 2
    try:
        jz = jax.jit(lambda p, v: jflow._prepare_cond_latents(
            p, v, key, 0.4))(params, jnp.asarray(video))
    finally:
        jflow.upscale = 1
    post = _t(np.asarray(jax.random.normal(k_enc, (1, 2, 8, 8, 4))))
    aug = _t(np.asarray(jax.random.normal(k_aug, (1, 2, 16, 16, 4))))
    z_cond = pflow._prepare_cond_latents(_t(video), None, 0.4, post, aug)
    _close(z_cond, jz, UNET_TOL)

    x = _t(rng.standard_normal((1, 2, 16, 16, 4), dtype=np.float32))
    y = _t(rng.standard_normal((1, 77, 32), dtype=np.float32))
    t = torch.tensor([700])
    with torch.no_grad():
        torch.testing.assert_close(
            pflow.denoise_apply(x, t, {"y": y}),
            pflow.denoise_apply(x, t, {"y": y,
                                       "z_cond": torch.zeros_like(x)}),
            rtol=0, atol=0)
        assert (pflow.denoise_apply(x, t, {"y": y, "z_cond": z_cond})
                - pflow.denoise_apply(x, t, {"y": y})).abs().max() > 0


def test_v2v_degradation_loss_matches_jax():
    """The loss on given latents: the clip downscaled 2× and back, its
    encode augmented at strength 1, q_sample at the JAX key's t and noise,
    the UNet on [x_t | z_cond], the text dropped where its key drops it."""
    jflow, pflow, params = _v2v()
    rng = np.random.default_rng(6)
    video = rng.uniform(-1, 1, (2, 2, 64, 64, 3)).astype(np.float32)
    z = rng.standard_normal((2, 2, 8, 8, 4), dtype=np.float32)
    text = rng.standard_normal((2, 77, 32), dtype=np.float32)
    key = jax.random.key(13)
    jl, _ = jax.jit(lambda p, b: jflow.training_loss(p, b, key))(
        params, {"video": jnp.asarray(video), "latents": jnp.asarray(z),
                 "text_states": jnp.asarray(text)})
    _, k_lr, k_t, k_noise, k_drop = jax.random.split(key, 5)
    k_enc2, k_aug = jax.random.split(k_lr)
    draws = {
        "cond_posterior_noise": jax.random.normal(k_enc2, z.shape),
        "aug_noise": jax.random.normal(k_aug, z.shape),
        "t": jax.random.randint(k_t, (2,), 0, 1000),
        "noise": jax.random.normal(k_noise, z.shape),
        "drop": jax.random.bernoulli(k_drop, jflow.uncond_prob, (2,))}
    draws = {k: _t(np.asarray(v)) for k, v in draws.items()}
    draws["t"] = draws["t"].long()
    with torch.no_grad():
        pl, aux = pflow.training_loss(
            {"video": _t(video), "latents": _t(z), "text_states": _t(text)},
            **draws)
    assert aux["loss"] is pl
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)


# ---------------------------------------------------------------- CLI
def _video_dir(tmp_path, frames=2, size=(64, 64)):
    import cv2
    d = tmp_path / "inputs"
    d.mkdir()
    rng = np.random.default_rng(0)
    writer = cv2.VideoWriter(str(d / "clip.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             (size[1], size[0]))
    for _ in range(frames):
        writer.write(rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    writer.release()
    (d / "clip.txt").write_text("a koi pond\n")
    return d


def test_v2v_command_and_enhancement_model_run_the_port(tmp_path, capsys):
    """``inference-v2v-ms`` (SDEdit over VideoCrafter2's DDIM, strength 1:
    both steps) through the registry and the enhancement model through
    ``cli/v2v``, narrowed, on a 2-frame 64×64 mp4 with its prompt
    sidecar: one enhanced video each, of the input's shape."""
    from videotuna_tpu_torch.data.video_io import load_video
    inputs = _video_dir(tmp_path)
    assert "inference-v2v-ms" not in pcommands.WAITING
    assert pcommands.COMMANDS["inference-v2v-ms"].mode == "v2v"
    assert pcommands.main(["inference-v2v-ms", "--device", "cpu", "--quiet",
                           "--input-dir", str(inputs), "--output-dir",
                           str(tmp_path / "ms"), "--strength", "1.0",
                           *NARROW]) == 0
    out = pcli.run_v2v(["--config", V2V_UNET, "--device", "cpu",
                        "--input-dir", str(inputs), "--output-dir",
                        str(tmp_path / "enh"), *NARROW])
    assert "enhanced 1 video" in capsys.readouterr().out
    for path in (tmp_path / "ms" / "clip.mp4", out["videos"][0]):
        video = load_video(str(path))
        assert video.shape == (2, 64, 64, 3)
    m = json.loads((tmp_path / "ms" / "metric.json").read_text())
    assert m["num_videos"] == 1 and m["per_video_sec"]["clip.mp4"] > 0
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no videos"):
        pcli.run_v2v(["--config", V2V_MS, "--device", "cpu", "--input-dir",
                      str(empty)])


def test_v2v_configs_name_a_missing_input_dir(monkeypatch):
    """ROADMAP.md queue 3: both V2V configs name inputs/v2v/001, which the
    repository lacks, so the JAX CLI fails on it without --input-dir (its
    flow replaced by a stub: the failure comes before any use) and the
    port's does too, before it builds the flow."""
    from videotuna_tpu.cli import v2v as jcli
    from videotuna_tpu_torch.core import config as pconfig
    root = os.path.dirname(CONFIGS)
    for path in (V2V_MS, V2V_UNET):
        assert pconfig.load_configs([path])["inference"]["input_dir"] == \
            "inputs/v2v/001"
    assert not os.path.isdir(os.path.join(root, "inputs", "v2v", "001"))
    monkeypatch.chdir(root)
    monkeypatch.setattr(jcli, "instantiate", lambda cfg: types.SimpleNamespace(
        params={"denoiser": {}}))
    with pytest.raises(FileNotFoundError, match="inputs/v2v/001"):
        jcli.run_v2v(["--config", V2V_MS])
    with pytest.raises(FileNotFoundError, match="inputs/v2v/001"):
        pcli.run_v2v(["--config", V2V_MS, "--device", "cpu"])
