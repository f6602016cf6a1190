"""The learned step (config 5) of tpufg_torch against tpufg's (CPU).

The bundled head (``checkpoints/head64_v4.npz``, v3d) on small synthetic
pans, through both packages' ``make_interp_step`` with the stream cache
(``q_feed``) and ``make_q_init``, and through both streaming engines.
Tolerances:
- output bytes within 1 code: the trunk agrees to f32 sum order with bf16
  roundings (tests/test_torch_rife.py), and at 2x the Lanczos bytes
  differ as in tests/test_torch_pipeline.py; at identity size at most
  1e-3 of the bytes may differ, upscaled 1e-2;
- curr at identity size: bitwise (passed through);
- the stream cache: quarter frames bitwise, features within 2e-6 of max
  |reference| (tpufg's encoder runs its Pallas conv, the port its plain
  version: f32 sums in another order);
- a step seeded with the previous step's cache equals the same step
  computing the cache itself: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufg.config import EngineConfig
from tpufg.engine import pipeline as jpipe
from tpufg.engine.runner import run_stream as jrun_stream
from tpufg.io.sinks import FrameSink
from tpufg.io.sources import SyntheticSource
from tpufg.models import rife as jrife
from tpufg_torch import cli
from tpufg_torch.engine import pipeline as tpipe
from tpufg_torch.engine.runner import run_stream
from tpufg_torch.models import rife

CPU = torch.device("cpu")
H, W = 48, 80


def _wire(h, w, n=3):
    return [f.view(np.int32).reshape(h, w)
            for f in SyntheticSource(w, h, n_frames=n)]


def _cfg(out_hw, in_hw=(H, W)):
    return EngineConfig(input_width=in_hw[1], input_height=in_hw[0],
                        output_width=out_hw[1], output_height=out_hw[0],
                        motion_mode="learned")


def _byte_diff(a, b):
    a = np.asarray(a).view(np.uint8).astype(np.int16)
    b = np.asarray(b).view(np.uint8).astype(np.int16)
    assert a.shape == b.shape
    return np.abs(a - b)


@pytest.fixture(scope="module")
def heads():
    path = rife.bundled_checkpoint()
    return jrife.load_params(path), rife.load_params(path)


@pytest.mark.parametrize("in_hw,out_hw", [((H, W), (H, W)),
                                          ((H, W), (2 * H, 2 * W)),
                                          ((40, 72), (40, 72))],
                         ids=["identity", "2x", "identity-padded"])
def test_q_feed_step_matches_tpufg(heads, in_hw, out_hw):
    """40 x 72 is off the 16-px lattice: both packages edge-pad the frames
    (and the seed's frame) to 48 x 80 and crop the in-between frame."""
    jparams, tparams = heads
    cfg = _cfg(out_hw, in_hw)
    fr = _wire(*in_hw)
    jstep = jpipe.make_interp_step(cfg, model_params=jparams, wire="i32",
                                   q_feed=True)
    tstep = tpipe.make_interp_step(cfg, wire="i32", device=CPU,
                                   model_params=tparams, q_feed=True)
    jq = jpipe.make_q_init(cfg, model_params=jparams)(jnp.asarray(fr[0]))
    tq = tpipe.make_q_init(cfg, tparams, CPU)(torch.from_numpy(fr[0]))
    for i in range(2):
        np.testing.assert_array_equal(tq[0].numpy(), np.asarray(jq[0]))
        ref_f = np.asarray(jq[1])
        assert np.abs(tq[1].numpy() - ref_f).max() <= 2e-6 * np.abs(
            ref_f).max()
        *jo, jq = jstep(jnp.asarray(fr[i]), jnp.asarray(fr[i + 1]), jq)
        *to, tq = tstep(torch.from_numpy(fr[i]), torch.from_numpy(fr[i + 1]),
                        tq)
        assert len(to) == len(jo) == 2
        for o in to:
            assert o.dtype == torch.int32 and tuple(o.shape) == out_hw
        d = _byte_diff(to[0].numpy(), jo[0])
        assert d.max() <= 1
        assert (d > 0).mean() <= (1e-3 if out_hw == in_hw else 1e-2)
        if out_hw == in_hw:
            np.testing.assert_array_equal(to[1].numpy(), fr[i + 1])
        else:
            assert _byte_diff(to[1].numpy(), jo[1]).max() <= 1


def test_stream_cache_is_bitwise(heads):
    """The q_feed step seeded with the previous step's cache gives the
    bytes (and the cache) of the plain step, which computes prev's cache
    itself; the mid frame is not a crossfade."""
    _, tparams = heads
    cfg = _cfg((H, W))
    fr = [torch.from_numpy(f) for f in _wire(H, W)]
    fed = tpipe.make_interp_step(cfg, wire="i32", device=CPU,
                                 model_params=tparams, q_feed=True)
    plain = tpipe.make_interp_step(cfg, wire="i32", device=CPU,
                                   model_params=tparams)
    *_, q = fed(fr[0], fr[1], tpipe.make_q_init(cfg, tparams, CPU)(fr[0]))
    *outs, q2 = fed(fr[1], fr[2], q)
    ref = plain(fr[1], fr[2])
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    q_ref = tpipe.make_q_init(cfg, tparams, CPU)(fr[2])
    for a, b in zip(q2, q_ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    cross = (fr[1].numpy().view(np.uint8).astype(np.float32)
             + fr[2].numpy().view(np.uint8)) / 2
    assert np.abs(outs[0].numpy().view(np.uint8) - cross).max() > 8


class _ListSink(FrameSink):
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(np.array(frame))


def test_run_stream_learned_matches_tpufg(heads):
    jparams, tparams = heads
    cfg = _cfg((H, W))
    ref, out = _ListSink(), _ListSink()
    jstats = jrun_stream(cfg, SyntheticSource(W, H, n_frames=4), ref,
                         paced=False, model_params=jparams)
    stats = run_stream(cfg, SyntheticSource(W, H, n_frames=4), out,
                       paced=False, device=CPU, model_params=tparams)
    assert stats.frames_in == jstats.frames_in == 4
    assert stats.frames_out == jstats.frames_out == len(out.frames) == 7
    for o, r in zip(out.frames, ref.frames):
        assert o.shape == r.shape == (H, W, 4) and o.dtype == np.uint8
        assert _byte_diff(o, r).max() <= 1


@pytest.mark.parametrize("name,head", [("head64.npz", "v1"),
                                       ("head64_v2.npz", "v2")])
def test_cli_refuses_v1_v2_heads_by_name(name, head):
    path = str(rife.bundled_checkpoint()).replace("head64_v4.npz", name)
    with pytest.raises(NotImplementedError, match=f"a {head} head"):
        cli.main(["synthetic:64x64", "--frames", "2", "--no-pacing",
                  "--motion-mode", "learned", "--model-path", path])
    cfg = EngineConfig(input_width=64, input_height=64, output_width=64,
                       output_height=64, motion_mode="learned")
    params = rife.load_params(path)
    with pytest.raises(NotImplementedError, match=head):
        tpipe.make_interp_step(cfg, device=CPU, model_params=params)
    with pytest.raises(NotImplementedError, match=head):
        tpipe.make_q_init(cfg, params, CPU)


def test_learned_step_needs_a_head():
    with pytest.raises(ValueError, match="model_params"):
        tpipe.make_interp_step(_cfg((H, W)), device=CPU)
