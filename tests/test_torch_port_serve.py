"""The port's serving layer (``serving/continuous.py``, ``cli/serve.py``)
against the JAX package and through real HTTP, on the CPU.

The step-level engine against the JAX engine in both families: DDIM on
``tiny_t2v.yaml``'s OpenSoraFlow (the JAX tree carried across with
``tools/from_jax``) and flow-matching Euler on a toy linear flow with the
same numpy weights on both sides; x_T and the conditions from a seeded
numpy generator, requests boarding at steps 0, 1 and 3; every completed
latent in f32 within 1e-4·max|x|, and within the same of the port's solo
``sample``.  Then the counterparts of ``tests/test_serve.py``'s cases on a
tiny port flow.  Every wait is bounded (``urlopen(timeout=)``,
``Event.wait(timeout=)``, joins with a timeout) and every server and service
is shut down in ``finally``."""

import contextlib
import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotuna_tpu.core import config as jconfig
from videotuna_tpu.core import registry as jregistry
from videotuna_tpu.schedulers import FlowMatchSchedule as JFlowMatch
from videotuna_tpu.serving import ContinuousBatchEngine as JEngine
from videotuna_tpu_torch.cli import serve as S
from videotuna_tpu_torch.core import config as pconfig
from videotuna_tpu_torch.core import registry as pregistry
from videotuna_tpu_torch.schedulers import DDIMSchedule, DDPMSchedule
from videotuna_tpu_torch.schedulers import FlowMatchSchedule as PFlowMatch
from videotuna_tpu_torch.serving import ContinuousBatchEngine as PEngine
from videotuna_tpu_torch.tools.from_jax import load_flow_params

from tests.test_torch_port_models import (  # noqa: F401
    jax_params, torch_one_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_T2V = os.path.join(ROOT, "configs", "000_tiny", "tiny_t2v.yaml")
TOL = 1e-4
CFG = 3.0
BOARD_AT = (0, 1, 3)      # the step before which each request boards
WAIT = 60                 # seconds: every wait of a test


def _close(out, ref, tol=TOL):
    out = np.asarray(out.detach().float() if isinstance(out, torch.Tensor)
                     else out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


# ---------------------------------------------------------------- toy flows
class _JToy:
    """The JAX side's toy flow (``tests/test_continuous_batching.py``'s):
    a fixed linear 'denoiser' conditioned on (t, cond['y'])."""

    def __init__(self, w, wy):
        self.scheduler = JFlowMatch.create(num_steps=5, shift=3.0)
        self.w, self.wy = jnp.asarray(w), jnp.asarray(wy)
        self.params = {}

    def latent_shape(self, b, f, h, w):
        return (b, f, h // 8, w // 8, 4)

    def denoise_apply(self, params, x, t, cond):
        tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1, 1) / 1000.0
        bias = (cond["y"].mean(axis=1) @ self.wy).reshape(-1, 1, 1, 1, 4)
        return jnp.tanh(x @ self.w) * (1.0 + 0.1 * tt) + bias


class _PToy:
    """The port's toy flow: the same function of the same numpy weights."""

    device = torch.device("cpu")

    def __init__(self, w, wy, scheduler=None):
        self.scheduler = scheduler or PFlowMatch.create(num_steps=5,
                                                        shift=3.0)
        self.w, self.wy = torch.from_numpy(w), torch.from_numpy(wy)

    latent_shape = _JToy.latent_shape

    def _attn_scope(self):
        return contextlib.nullcontext()

    def denoise_apply(self, x, t, cond):
        tt = t.float().reshape(-1, 1, 1, 1, 1) / 1000.0
        bias = (cond["y"].mean(dim=1) @ self.wy).reshape(-1, 1, 1, 1, 4)
        return torch.tanh(x @ self.w) * (1.0 + 0.1 * tt) + bias

    def sample(self, cond, uncond, shape, generator, cfg_scale, x_T):
        from videotuna_tpu_torch.schedulers import cfg_denoise
        return self.scheduler.sample(
            cfg_denoise(self.denoise_apply, cond, uncond, cfg_scale),
            shape, generator, x_T=x_T)


def _toy_weights():
    rng = np.random.default_rng(11)
    return ((rng.standard_normal((4, 4)) * 0.2).astype(np.float32),
            (rng.standard_normal((6, 4)) * 0.2).astype(np.float32))


@functools.cache
def _tiny_ddim():
    """``tiny_t2v.yaml`` (DDIM, 4 steps) in both packages with the same
    seeded weights."""
    jcfg = jconfig.load_configs([TINY_T2V])
    jregistry.populate()
    jflow = jregistry.instantiate(jcfg["flow"])
    pflow = pregistry.instantiate(pconfig.load_configs([TINY_T2V])["flow"],
                                  device="cpu")
    ex = jflow.example_inputs()
    params = {c: jax_params(getattr(jflow, c), *ex[c], seed=i,
                            like=getattr(pflow, c))
              for i, c in enumerate(("denoiser", "first_stage",
                                     "cond_stage"))}
    load_flow_params(pflow, params)
    jflow.params = params
    return jflow, pflow


def _family(family):
    """(JAX flow, port flow, engine geometry, conditioning of a request)."""
    if family == "ddim":
        jflow, pflow = _tiny_ddim()

        def cond(rng, i):
            mask = np.zeros((1, 8), bool)
            mask[0, :2 + 2 * i] = True
            return {"y": rng.standard_normal((1, 8, 16), dtype=np.float32),
                    "mask": mask}
        return jflow, pflow, (4, 64, 64), cond
    w, wy = _toy_weights()
    return (_JToy(w, wy), _PToy(w, wy), (2, 16, 16),
            lambda rng, i: {"y": rng.standard_normal((1, 3, 6),
                                                     dtype=np.float32)})


def _requests(family, n=3):
    _, pflow, (f, h, w), cond = _family(family)
    rng = np.random.default_rng(5)
    shape = pflow.latent_shape(1, f, h, w)
    return [(rng.standard_normal(shape, dtype=np.float32), cond(rng, i),
             cond(rng, i)) for i in range(n)]


def _to(pkg, req):
    x, c, u = req
    if pkg == "jax":
        return (jnp.asarray(x), *({k: jnp.asarray(v) for k, v in d.items()}
                                  for d in (c, u)))
    return (torch.from_numpy(x), *({k: torch.from_numpy(v)
                                    for k, v in d.items()} for d in (c, u)))


def _drive(engine, pkg, reqs, board_at=BOARD_AT):
    """Board request j before step ``board_at[j]`` and step until every
    request completes: {request: final latents}."""
    slot_of, got = {}, {}
    for step in range(40):
        for j, at in enumerate(board_at):
            if at == step:
                slot_of[engine.submit(*_to(pkg, reqs[j]))] = j
        engine.step()
        for slot, z in engine.poll_completed():
            got[slot_of.pop(slot)] = np.asarray(z)
        if len(got) == len(reqs):
            return got
    raise AssertionError(f"engine did not drain: {sorted(got)}")


@functools.cache
def _engines_ran(family):
    jflow, pflow, (f, h, w), _ = _family(family)
    reqs = _requests(family)
    kw = dict(slots=3, frames=f, height=h, width=w, cfg_scale=CFG)
    return (reqs, _drive(JEngine(jflow, **kw), "jax", reqs),
            _drive(PEngine(pflow, **kw), "torch", reqs))


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("family", ["ddim", "flow"])
def test_engine_staggered_arrivals_match_jax_engine(family):
    _, jgot, pgot = _engines_ran(family)
    assert sorted(jgot) == sorted(pgot) == [0, 1, 2]
    for j in range(3):
        _close(pgot[j], jgot[j])


@pytest.mark.parametrize("family", ["ddim", "flow"])
def test_engine_matches_solo_sample(family):
    reqs, _, pgot = _engines_ran(family)
    pflow = _family(family)[1]
    for j, req in enumerate(reqs):
        x, c, u = _to("torch", req)
        ref = pflow.sample(c, u, tuple(x.shape), None, CFG, x_T=x)
        _close(pgot[j], ref)


def test_inactive_slots_do_not_move_and_drain():
    w, wy = _toy_weights()
    eng = PEngine(_PToy(w, wy), slots=2, frames=2, height=16, width=16,
                  cfg_scale=CFG)
    reqs = _requests("flow", 2)
    s = eng.submit(*_to("torch", reqs[0]))
    eng.step()
    assert torch.equal(eng.x[1 - s], torch.zeros_like(eng.x[1 - s]))
    assert eng.k.tolist()[s] == 1 and eng.k.tolist()[1 - s] == 0
    assert eng.submit(*_to("torch", reqs[1])) == 1 - s
    assert eng.submit(*_to("torch", reqs[1])) is None     # full
    done = eng.run_to_completion(max_steps=10)
    assert [slot for slot, _ in done] == [s, 1 - s] and eng.n_active == 0
    assert not eng.active.any()


def _cogvideox_dpm_flows():
    cfg = ["flow.params.scheduler_config.target="
           "videotuna_tpu.schedulers.CogVideoXDPMSchedule",
           "flow.params.scheduler_config.params.num_steps=2"]
    path = os.path.join(ROOT, "configs", "000_tiny", "tiny_cogvideox.yaml")
    jregistry.populate()
    return (jregistry.instantiate(jconfig.load_configs([path], cfg)["flow"]),
            pregistry.instantiate(pconfig.load_configs([path], cfg)["flow"],
                                  device="cpu"))


@pytest.mark.parametrize("what", ["ddim_eta", "cogvideox_dpm", "unipc",
                                  "spaced"])
def test_unsupported_schedules_raise_like_jax(what):
    """η > 0 DDIM and every schedule but flow matching and DDIM raise in
    the port where they raise in the JAX engine."""
    from videotuna_tpu import schedulers as JS
    from videotuna_tpu_torch import schedulers as PS
    if what == "cogvideox_dpm":
        jflow, pflow = _cogvideox_dpm_flows()
        scheds = (jflow.scheduler, pflow.scheduler)
    elif what == "ddim_eta":
        scheds = (JS.DDIMSchedule.create(JS.DDPMSchedule.create(timesteps=50),
                                         num_steps=4, eta=0.5),
                  DDIMSchedule.create(DDPMSchedule.create(timesteps=50),
                                      num_steps=4, eta=0.5))
    elif what == "unipc":
        scheds = (JS.FlowUniPCSchedule.create(num_steps=4),
                  PS.FlowUniPCSchedule.create(num_steps=4))
    else:
        scheds = (JS.SpacedSchedule.create(timesteps=100,
                                           section_counts="5"),
                  PS.SpacedSchedule.create(timesteps=100,
                                           section_counts="5"))
    w, wy = _toy_weights()
    jflow, pflow = _JToy(w, wy), _PToy(w, wy)
    jflow.scheduler, pflow.scheduler = scheds
    match = "η=0" if what == "ddim_eta" else "unsupported schedule"
    for engine, flow in ((JEngine, jflow), (PEngine, pflow)):
        with pytest.raises(NotImplementedError, match=match):
            engine(flow, slots=2, frames=2, height=16, width=16)


# ---------------------------------------------------------------- services
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=WAIT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@contextlib.contextmanager
def _running(server):
    """The server's loop in a daemon thread; shut down on the way out,
    with the service's worker."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=WAIT)
        if hasattr(server.service, "shutdown"):
            server.service.shutdown()


@pytest.fixture(scope="module")
def tiny_server(tmp_path_factory):
    cfg = pconfig.load_configs([TINY_T2V], ["flow.params.ddim_steps=2"])
    cfg["inference"]["savedir"] = str(tmp_path_factory.mktemp("serve"))
    with _running(S.serve(cfg, port=0, device="cpu")) as url:
        yield url


def test_service_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = pconfig.load_configs([TINY_T2V])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.InferenceService(cfg)


def test_healthz_generate_and_metrics(tiny_server):
    code, body, _ = _get(tiny_server + "/healthz")
    assert code == 200 and body["status"] == "ok"
    assert body["model"] == "OpenSoraFlow"
    code, body, _ = _post(tiny_server + "/generate",
                          {"prompt": "a tiny robot", "seed": 5})
    assert code == 200, body
    assert len(body["videos"]) == 1 and body["videos"][0].endswith(".mp4")
    assert os.path.isfile(body["videos"][0]) and body["time_sec"] > 0
    code, m, _ = _get(tiny_server + "/metrics")
    assert code == 200 and m["requests_served"] >= 1
    assert {"requests_served", "requests_rejected", "requests_timed_out",
            "queue_depth", "max_queue"} <= set(m)


def test_unknown_route_and_bad_request_survive(tiny_server):
    assert _post(tiny_server + "/nope", {})[0] == 404
    assert _get(tiny_server + "/nope")[0] == 404
    code, body, _ = _post(tiny_server + "/generate",
                          {"frames": "not-a-number"})
    assert code == 500 and "error" in body
    assert _get(tiny_server + "/healthz")[0] == 200


class _StubBatching(S.BatchingInferenceService):
    """Micro-batching over a stub sampler that records each batch (and
    may sleep in it)."""

    def __init__(self, calls, sleep=0.0, **kw):
        self.calls, self.sleep = calls, sleep
        super().__init__({"inference": {"savedir": "unused"}},
                         flow=object(), **kw)

    def _infer(self, cfg):
        time.sleep(self.sleep)
        prompts = cfg["inference"]["prompts_list"]
        self.calls.append(list(prompts))
        return {"videos": [f"v-{p}.mp4" for p in prompts]}


def _concurrently(fn, args):
    results, errors = {}, {}

    def run(i, a):
        try:
            results[i] = fn(*a)
        except Exception as e:  # noqa: BLE001 — the test reads it
            errors[i] = e
    ts = [threading.Thread(target=run, args=(i, a), daemon=True)
          for i, a in enumerate(args)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in ts)
    return results, errors


@pytest.mark.parametrize("heights", [(64, 64, 64), (64, 128)],
                         ids=["coalesces", "mixed_geometry_splits"])
def test_batching_by_geometry(heights):
    calls = []
    svc = _StubBatching(calls, max_batch=4, max_wait_ms=120.0)
    try:
        results, errors = _concurrently(
            lambda i, h: svc.generate({"prompt": f"p{i}", "height": h}),
            list(enumerate(heights)))
    finally:
        svc.shutdown()
    assert not errors, errors
    assert sorted(sum(calls, [])) == [f"p{i}" for i in range(len(heights))]
    if len(set(heights)) == 1:
        assert len(calls) <= 2                       # coalesced
    else:
        assert all(len(c) == 1 for c in calls)       # never mixed
    for i in range(len(heights)):
        assert results[i]["videos"] == [f"v-p{i}.mp4"]
        assert results[i]["batched_with"] >= 1


def test_queue_full_429_deadline_504_and_metrics():
    calls = []
    svc = _StubBatching(calls, sleep=1.0, request_timeout_s=0.2)
    server = S.ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(svc))
    server.service = svc
    with _running(server) as url:
        # the worker holds the first request in its 1 s batch; the second
        # (another geometry) waits past its 0.2 s deadline
        results, _ = _concurrently(
            lambda p: _post(url + "/generate", p),
            [({"prompt": "a"},), ({"prompt": "b", "height": 999},)])
        assert {r[0] for r in results.values()} == {504}
        svc.max_queue = 0
        code, body, headers = _post(url + "/generate", {"prompt": "c"})
        assert code == 429 and "queue full" in body["error"]
        assert headers.get("Retry-After") == "5"
        code, m, _ = _get(url + "/metrics")
    assert m["requests_timed_out"] == 2 and m["requests_rejected"] == 1


def test_mesh_of_four_raises_naming_item_10_1():
    cfg = pconfig.load_configs([TINY_T2V])
    cfg["inference"]["mesh"] = {"dp": 2, "fsdp": 2}
    with pytest.raises(NotImplementedError, match="item 10.1"):
        S.InferenceService(cfg, device="cpu")
    cfg["inference"]["mesh"] = {"dp": 1, "fsdp": 1}
    svc = S.InferenceService(cfg, flow=object())
    assert svc.queue_depth == 0


class _ServedToy(_PToy):
    """A toy flow the continuous service can run: text → a constant
    caption by prompt length, latents → pixels in [-1, 1]."""

    use_dynamic_cfg = False

    def __init__(self):
        super().__init__(*_toy_weights(),
                         scheduler=PFlowMatch.create(num_steps=3, shift=1.0))

    def encode_text(self, texts):
        return {"y": torch.full((1, 2, 6), len(texts[0]) / 100.0)}

    def decode_latents(self, z):
        z = (z[..., :3] * 0.3).clamp(-1, 1)
        return z.repeat_interleave(8, 2).repeat_interleave(8, 3)


def _continuous(tmp_path, slots=2):
    cfg = {"inference": {"height": 32, "width": 32, "frames": 2,
                         "savedir": str(tmp_path),
                         "unconditional_guidance_scale": CFG}}
    return S.ContinuousBatchingService(cfg, slots=slots, flow=_ServedToy())


def test_continuous_concurrent_requests_complete(tmp_path):
    svc = _continuous(tmp_path, slots=2)
    try:
        results, errors = _concurrently(
            lambda i: svc.generate({"prompt": f"prompt {i}", "seed": i}),
            [(i,) for i in range(4)])            # 4 requests > 2 slots
    finally:
        svc.shutdown()
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    for r in results.values():
        assert r["continuous"] and len(r["videos"]) == 1
        assert os.path.exists(r["videos"][0])
    assert svc.requests_served == 4 and svc.engine.n_active == 0


def test_continuous_geometry_mismatch_400(tmp_path):
    svc = _continuous(tmp_path)
    server = S.ThreadingHTTPServer(("127.0.0.1", 0), S.make_handler(svc))
    server.service = svc
    with _running(server) as url:
        code, body, _ = _post(url + "/generate", {"prompt": "x",
                                                   "height": 64})
    assert code == 400 and "fixed geometry" in body["error"]


def test_continuous_per_request_negative_prompt(tmp_path):
    """The uncond cache is keyed by the negative prompt, so a later
    request's negative prompt changes its guidance."""
    from videotuna_tpu_torch.data.video_io import load_video
    svc = _continuous(tmp_path, slots=1)
    try:
        r1 = svc.generate({"prompt": "same", "seed": 7,
                           "negative_prompt": "aa"})
        r2 = svc.generate({"prompt": "same", "seed": 7,
                           "negative_prompt": "aaaaaaaaaa"})
    finally:
        svc.shutdown()
    v1, v2 = (load_video(r["videos"][0]).astype(np.float32)
              for r in (r1, r2))
    assert float(np.abs(v1 - v2).max()) > 1.0      # uint8 scale


def test_continuous_abandoned_requests_never_board(tmp_path):
    svc = _continuous(tmp_path)
    try:
        dead = {"req": {"prompt": "dead", "seed": 0},
                "event": threading.Event(), "result": None,
                "error": None, "abandoned": True, "t0": 0.0}
        with svc._cv:
            svc._pending.append(dead)
        svc._admit()
        assert svc.engine.n_active == 0 and not svc._slot_items
    finally:
        svc.shutdown()
