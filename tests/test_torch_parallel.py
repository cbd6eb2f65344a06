"""The port's ``parallel.mesh`` and ``parallel.sharded`` against the JAX
package's, float64 on the CPU.  The JAX side runs in this process on its
forced 8-device CPU mesh (4 data x 2 model), as tests/test_parallel.py runs
it; the port runs in this process with ``mesh=None`` (one process, no
collective) and in 2 gloo ranks spawned by ``parallel.distributed``'s
dryruns, whose inputs this file writes.  Griffin-Lim inits are JAX's
threefry draws, passed into both packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as tdist

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.parallel import mesh as j_mesh
from closed_loop_seeg_speech_synthesis_tpu.parallel import sharded as j_sharded
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.models import selection as t_sel
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import distributed as t_dist
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import mesh as t_mesh
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import sharded as t_sharded
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

SR = 1024.0


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return j_mesh.make_mesh(8)


@pytest.fixture
def world1(tmp_path):
    """A process group of one gloo rank in this process, for the lifetime of
    one test."""
    t_dist.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        tdist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        t_mesh.make_mesh()


def test_make_mesh_shape_and_errors(world1):
    """Dims ("data", "model") over the group's ranks, the JAX package's errors
    (tests/test_parallel.py::test_make_mesh_errors), and this rank's blocks."""
    m = t_mesh.make_mesh()
    assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
    assert t_dist.global_mesh().mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="only 1 exist"):
        t_mesh.make_mesh(2)
    with pytest.raises(ValueError, match="does not divide"):
        t_mesh.make_mesh(1, model_axis=3)
    with pytest.raises(ValueError, match="does not divide"):
        t_dist.global_mesh(model_axis=2)
    assert t_mesh.session_sharding(m, 4, 16) == (slice(0, 4), slice(0, 16))
    assert t_mesh.feature_sharding(m, 80) == slice(0, 80)
    assert t_mesh.session_sharding(None, 4, 16) == (slice(0, 4), slice(0, 16))
    assert t_mesh.feature_sharding(None, 80) == slice(0, 80)
    x = torch.arange(6.0).reshape(2, 3)
    assert t_mesh.all_gather(x, m, "data") is x and t_mesh.all_reduce_sum(x, m, "model") is x


@pytest.mark.parametrize("values,k", [
    ([0.5, np.nan, 0.9, 0.5, np.nan, 0.1, 0.9, 0.0], 8),
    ([0.5, np.nan, 0.9, 0.5, np.nan, 0.1, 0.9, 0.0], 5),
    ([0.3] * 6 + [0.7] * 6, 9),
    ([np.nan] * 5 + [0.0] * 5, 7),
])
def test_top_k_orders_as_jax(values, k):
    """Ties lowest index first, NaN above every number: jax.lax.top_k's order."""
    v = np.asarray(values)
    _, ref = jax.lax.top_k(jnp.asarray(v), k)
    np.testing.assert_array_equal(t_sel.top_k(torch.as_tensor(v), k).numpy(), np.asarray(ref))


def _jax_train(mesh8, eeg, audio, nb_feats):
    cfg = j_sharded.ShardedTrainConfig(dtype=jnp.float64, nb_feats=nb_feats, iir_block=128)
    B, T, C = eeg.shape
    step, (eeg_sh, audio_sh) = j_sharded.make_sharded_train_step(mesh8, cfg, T, audio.shape[1], C)
    params, select, medians = step(jax.device_put(jnp.asarray(eeg), eeg_sh),
                                   jax.device_put(jnp.asarray(audio), audio_sh))
    return {"coef": np.asarray(params.coef), "intercept": np.asarray(params.intercept),
            "valid": np.asarray(params.valid), "select": np.asarray(select),
            "medians": np.asarray(medians)}


def _port_train(eeg, audio, nb_feats):
    cfg = t_sharded.ShardedTrainConfig(dtype=torch.float64, nb_feats=nb_feats, iir_block=128)
    B, T, C = eeg.shape
    step = t_sharded.make_sharded_train_step(None, cfg, T, audio.shape[1], C, device="cpu")
    params, select, medians = step(eeg, audio)
    return {"coef": params.coef.numpy(), "intercept": params.intercept.numpy(),
            "valid": params.valid.numpy(), "select": select.numpy(), "medians": medians.numpy()}


def _assert_model_matches(port, ref):
    np.testing.assert_array_equal(port["select"], ref["select"])
    np.testing.assert_allclose(port["medians"], ref["medians"], rtol=1e-10)
    np.testing.assert_array_equal(port["valid"], ref["valid"])
    np.testing.assert_allclose(port["coef"], ref["coef"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(port["intercept"], ref["intercept"], rtol=1e-6, atol=1e-9)


def _train_batch(seed=0):
    """tests/test_parallel.py's training case: B=4, T=2048, C=16."""
    rng = np.random.RandomState(seed)
    B, T, C = 4, 2048, 16
    Ta = int(T / SR * 16000)
    return rng.randn(B, T, C), rng.randn(B, Ta) * 0.1


def test_sharded_train_step_matches_jax(mesh8):
    """One process (mesh=None) against the JAX step on 4 data x 2 model."""
    eeg, audio = _train_batch()
    port = _port_train(eeg, audio, 12)
    assert port["coef"].shape == (40, 9, 12) and np.isfinite(port["coef"]).all()
    _assert_model_matches(port, _jax_train(mesh8, eeg, audio, 12))


@pytest.mark.parametrize("model_axis", [1, 2])
def test_sharded_train_step_two_ranks_matches_jax(mesh8, tmp_path, model_axis):
    """2 gloo ranks: data=2 (each featurizes its 2 sessions; the features and
    spectrograms are gathered over data) or model=2 (each featurizes its 8
    channels of all 4 sessions; the feature blocks are gathered over
    model).  Both replicas equal, and equal to JAX's."""
    eeg, audio = _train_batch()
    inputs = t_dist.write_inputs(str(tmp_path / "inputs"), eeg=eeg, audio=audio)
    reps, _ = t_dist.dryrun_dcn_train(2, backend="gloo", device="cpu", model_axis=model_axis,
                                      inputs=inputs, config={"nb_feats": 12, "iir_block": 128},
                                      workdir=str(tmp_path), timeout=240)
    data = 2 // model_axis
    assert [r["mesh"] for r in reps] == [[data, model_axis]] * 2
    assert [r["sessions"] for r in reps] == ([[0, 2], [2, 4]] if data == 2 else [[0, 4]] * 2)
    for k in ("coef", "intercept", "classes", "valid", "select", "medians"):
        np.testing.assert_array_equal(reps[0][k], reps[1][k])
    _assert_model_matches(reps[0], _jax_train(mesh8, eeg, audio, 12))


@pytest.mark.parametrize("case", ["duplicated channels", "silent audio"])
def test_sharded_train_step_ties_and_nan(mesh8, case):
    """Tied and NaN |rho| columns.  Channels 7 and 14 copy channel 5, so
    their 5 context taps tie with channel 5's exactly; all 80 features are
    selected, so the whole order counts.  Silent audio gives a constant
    target, so every rho is NaN (zero rank variance); top_k ranks NaN above
    every number and ties lowest index first.  The select is JAX's."""
    eeg, audio = _train_batch(seed=3)
    eeg[:, :, 7] = eeg[:, :, 5]
    eeg[:, :, 14] = eeg[:, :, 5]
    nb_feats = 80
    if case == "silent audio":
        audio[:] = 0.0
        nb_feats = 12
    ref = _jax_train(mesh8, eeg, audio, nb_feats)
    port = _port_train(eeg, audio, nb_feats)
    if case == "silent audio":
        np.testing.assert_array_equal(ref["select"], np.arange(12)[::-1])
    np.testing.assert_array_equal(port["select"], ref["select"])
    np.testing.assert_allclose(port["medians"], ref["medians"], rtol=1e-10)


def _decode_case(seed, C=16, T=2048):
    """tests/test_parallel.py's decode case: a random 20-feature model."""
    rng = np.random.RandomState(seed)
    arrays = dict(lda_coef=rng.randn(40, 9, 20), lda_intercept=rng.randn(40, 9),
                  lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                  lda_valid=np.ones((40, 9), bool))
    arrays["medians"] = np.sort(rng.randn(40, 9), 1)
    arrays["select"] = rng.permutation(5 * C)[:20]
    return arrays, rng


def _jax_decoder(arrays, C):
    cfg = j_pipe.DecoderConfig(sr=SR, n_channels=C, dtype=jnp.float64)
    lda = j_lda.LDAParams(coef=jnp.asarray(arrays["lda_coef"]),
                          intercept=jnp.asarray(arrays["lda_intercept"]),
                          classes=jnp.asarray(arrays["lda_classes"]),
                          valid=jnp.asarray(arrays["lda_valid"]))
    return cfg, j_pipe.build_decoder_params(cfg, lda, arrays["medians"], arrays["select"])


def _port_decoder(arrays, C):
    loaded = t_params.from_arrays(**arrays, bad_channels=[])
    cfg = t_pipe.DecoderConfig(sr=SR, n_channels=C, dtype=torch.float64)
    return cfg, t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                            loaded["select"], device="cpu")


def _jax_inits(n_sessions, nf):
    return np.stack([np.asarray(j_gl.default_rand_init(jax.random.PRNGKey(i), nf - 1, 0,
                                                       jnp.float64))
                     for i in range(n_sessions)])


def _assert_decodes_match(spec, audio, spec_ref, audio_ref):
    np.testing.assert_allclose(np.asarray(spec), np.asarray(spec_ref), rtol=1e-9, atol=1e-12)
    assert np.abs(np.asarray(audio, int) - np.asarray(audio_ref, int)).max() <= 1


def test_channel_sharded_decode_matches_jax(mesh8, tmp_path):
    """The session's 16 channels over 2 gloo ranks (model=2): each rank's 8
    channels' features against its block of the LDA weights, the products
    summed across the ranks; both ranks' output equals JAX's channel-sharded
    decode and the port's unsharded decode.  One process (mesh=None) too."""
    C, T = 16, 2048
    arrays, rng = _decode_case(4, C, T)
    j_cfg, j_dec = _jax_decoder(arrays, C)
    ends = j_fr.streaming_frame_ends(50, 10, SR, T + j_cfg.prefill)
    nf = len(ends)
    eeg = rng.randn(T, C)
    rand = _jax_inits(1, nf)
    decode, eeg_sh = j_sharded.make_sharded_decode(mesh8, j_dec, j_cfg, nf)
    spec_j, audio_j = decode(jax.device_put(jnp.asarray(eeg), eeg_sh),
                             jnp.asarray(ends, jnp.int32), jnp.asarray(rand[0]))

    cfg, dec = _port_decoder(arrays, C)
    spec_1, audio_1 = t_sharded.make_sharded_decode(None, dec, cfg, nf)(eeg, rand[0])
    _assert_decodes_match(spec_1, audio_1, spec_j, audio_j)
    spec_u, audio_u = t_pipe.offline_decode(dec, cfg, eeg, rand_init=rand[0])
    assert torch.equal(spec_1, spec_u) and torch.equal(audio_1, audio_u)

    inputs = t_dist.write_inputs(str(tmp_path / "inputs"), eeg=eeg[None], rand=rand, sr=SR,
                                 **arrays)
    ranks, _ = t_dist.dryrun_dcn(2, backend="gloo", device="cpu", model_axis=2, inputs=inputs,
                                 workdir=str(tmp_path), timeout=240)
    assert [r["mesh"] for r in ranks] == [[1, 2], [1, 2]]
    for r in ranks:
        assert r["sessions"] == [0, 1]
        _assert_decodes_match(r["spec"][0], r["audio"][0], spec_j, audio_j)
        _assert_decodes_match(r["spec"][0], r["audio"][0], spec_u, audio_u)
    np.testing.assert_array_equal(ranks[0]["spec"], ranks[1]["spec"])
    np.testing.assert_array_equal(ranks[0]["audio"], ranks[1]["audio"])


def test_batched_replay_matches_jax(mesh8):
    """B = 4 sessions through the port's batched replay (one process) against
    JAX's make_batched_replay on the 8-device mesh, session by session."""
    C, T, B = 16, 2048, 4
    arrays, rng = _decode_case(1, C, T)
    j_cfg, j_dec = _jax_decoder(arrays, C)
    ends = j_fr.streaming_frame_ends(50, 10, SR, T + j_cfg.prefill)
    nf = len(ends)
    eeg = rng.randn(B, T, C)
    rand = _jax_inits(B, nf)
    replay = j_sharded.make_batched_replay(mesh8, j_pipe._offline_decode_jit, j_cfg, nf)
    specs_j, audios_j = replay(j_dec, jnp.asarray(eeg), jnp.asarray(ends, jnp.int32),
                               jnp.asarray(rand))

    cfg, dec = _port_decoder(arrays, C)
    specs, audios = t_sharded.make_batched_replay(None, cfg, nf)(dec, eeg, rand)
    assert specs.shape == (B, nf, 40) and audios.shape == (B, (nf - 1) * 160)
    for b in range(B):
        _assert_decodes_match(specs[b], audios[b], specs_j[b], audios_j[b])
    with pytest.raises(ValueError, match="frames"):
        t_sharded.make_batched_replay(None, cfg, nf + 1)(dec, eeg, rand)
