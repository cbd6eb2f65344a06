"""The port's ``parallel.distributed`` on the CPU: 2 real processes
(``subprocess``, gloo, a ``file://`` rendezvous in the test's directory)
run the data-parallel replay and fit one model from a session batch split
over them, as tests/test_distributed.py runs the JAX package's dryruns.
Each rank's shard is held against a single-process run of the same
sessions, and against the JAX package (float64, the same inits); the
trained model is carried into both packages' decoders."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.parallel import distributed as j_dist
from closed_loop_seeg_speech_synthesis_tpu.parallel import mesh as j_mesh
from closed_loop_seeg_speech_synthesis_tpu.parallel import sharded as j_sharded
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import distributed as t_dist
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import sharded as t_sharded
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

SR = 1024.0


def _port_decode(arrays, eeg, rand):
    loaded = t_params.from_arrays(*(arrays[k] for k in t_dist.LDA_ARRAYS), [])
    cfg = t_pipe.DecoderConfig(sr=SR, n_channels=eeg.shape[1], dtype=torch.float64)
    dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                      device="cpu")
    spec, audio = t_pipe.offline_decode(dec, cfg, eeg, rand_init=rand)
    return spec.numpy(), audio.numpy()


def _jax_decode(arrays, eeg, rand):
    cfg = j_pipe.DecoderConfig(sr=SR, n_channels=eeg.shape[1], dtype=jnp.float64)
    lda = j_lda.LDAParams(coef=jnp.asarray(arrays["lda_coef"]),
                          intercept=jnp.asarray(arrays["lda_intercept"]),
                          classes=jnp.asarray(arrays["lda_classes"]),
                          valid=jnp.asarray(arrays["lda_valid"]))
    dec = j_pipe.build_decoder_params(cfg, lda, arrays["medians"], arrays["select"])
    spec, audio = j_pipe.offline_decode(dec, cfg, eeg, rand_init=rand)
    return np.asarray(spec), np.asarray(audio)


def _assert_decodes_match(spec, audio, spec_ref, audio_ref):
    np.testing.assert_allclose(spec, spec_ref, rtol=1e-9, atol=1e-12)
    assert np.abs(audio.astype(int) - audio_ref.astype(int)).max() <= 1


def test_dcn_dryrun_matches_local(tmp_path):
    """2 ranks x 2 sessions (regenerated by each rank from seed 0): the
    shards, concatenated in rank order, equal the single-process decode of
    the 4 sessions, and the JAX package's decode of them."""
    ranks, logs = t_dist.dryrun_dcn(2, backend="gloo", device="cpu", workdir=str(tmp_path),
                                    timeout=240)
    assert len(ranks) == 2 and len(logs) == 2
    assert [r["mesh"] for r in ranks] == [[2, 1], [2, 1]]
    assert [r["sessions"] for r in ranks] == [[0, 2], [2, 4]]
    # the CPU runs the kernels' plain versions, which count no launch
    assert all(n == 0 for r in ranks for n in r["launches"].values())
    assert all(r["collectives_ms"] == 0.0 for r in ranks)  # the replay moves nothing
    spec = np.concatenate([r["spec"] for r in ranks])
    audio = np.concatenate([r["audio"] for r in ranks])
    inputs = t_dist.replay_inputs(4)
    assert spec.shape == (4, 200, 40) and audio.shape == (4, 199 * 160)
    for i in range(4):
        ref = _port_decode(inputs, inputs["eeg"][i].astype(np.float64), inputs["rand"][i])
        _assert_decodes_match(spec[i], audio[i], *ref)
    _assert_decodes_match(spec[3], audio[3], *_jax_decode(
        inputs, inputs["eeg"][3].astype(np.float64), inputs["rand"][3]))


def test_dcn_train_matches_local(tmp_path):
    """2 ranks fit one model from 4 sessions (2 each, regenerated from seed
    7): every rank holds the same replica; it equals the single-process
    step on the pooled batch and the JAX package's distributed_train of it
    (tests/test_distributed.py:73-77's tolerances); the JAX model, carried
    across by from_arrays, decodes in the port as in JAX, and so does the
    port's."""
    reps, _ = t_dist.dryrun_dcn_train(2, backend="gloo", device="cpu", workdir=str(tmp_path),
                                      timeout=240)
    assert len(reps) == 2
    for k in ("coef", "intercept", "classes", "valid", "select", "medians"):
        np.testing.assert_array_equal(reps[0][k], reps[1][k])
    rep = reps[0]
    assert rep["collectives_ms"] > 0.0  # the features and spectrograms were gathered

    pooled = t_dist.train_inputs(4)
    eeg, audio = pooled["eeg"].astype(np.float64), pooled["audio"].astype(np.float64)
    cfg = t_sharded.ShardedTrainConfig(dtype=torch.float64, nb_feats=16, iir_block=128)
    params, select, medians = t_dist.distributed_train(None, cfg, eeg, audio, device="cpu")
    j_cfg = j_sharded.ShardedTrainConfig(dtype=jnp.float64, nb_feats=16, iir_block=128)
    j_params, j_select, j_medians = j_dist.distributed_train(
        j_mesh.make_mesh(4, model_axis=1), j_cfg, eeg, audio)
    for sel, med, coef, icpt in ((select, medians, params.coef.numpy(), params.intercept.numpy()),
                                 (j_select, j_medians, j_params.coef, j_params.intercept)):
        np.testing.assert_array_equal(sel, rep["select"])
        np.testing.assert_allclose(med, rep["medians"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(coef, rep["coef"], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(icpt, rep["intercept"], rtol=1e-3, atol=1e-3)

    j_model = {"lda_coef": j_params.coef, "lda_intercept": j_params.intercept,
               "lda_classes": j_params.classes, "lda_valid": j_params.valid,
               "medians": j_medians, "select": j_select}
    t_model = {"lda_coef": rep["coef"], "lda_intercept": rep["intercept"],
               "lda_classes": rep["classes"], "lda_valid": rep["valid"],
               "medians": rep["medians"], "select": rep["select"]}
    x = eeg[0]
    nf = len(t_dist.replay_inputs(1)["rand"][0]) + 1
    rand = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (nf - 1, 480), jnp.float64))
    spec_j, audio_j = _jax_decode(j_model, x, rand)
    _assert_decodes_match(*_port_decode(j_model, x, rand), spec_j, audio_j)
    _assert_decodes_match(*_port_decode(t_model, x, rand), spec_j, audio_j)


def test_backend_rules(tmp_path):
    """The backend is the caller's: NCCL with more ranks than cards raises
    before anything starts, as do an unknown backend and an init method
    that is neither tcp:// nor file://."""
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one rank per card"):
        t_dist.initialize(f"file://{tmp_path / 'r'}", n_cards + 1, 0, backend="nccl")
    with pytest.raises(ValueError, match="one rank per card"):
        t_dist.dryrun_dcn(n_cards + 1, backend="nccl", device="cpu", workdir=str(tmp_path))
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        t_dist.dryrun_dcn_train(2, backend="mpi", device="cpu", workdir=str(tmp_path))
    with pytest.raises(ValueError, match="tcp://host:port or file://"):
        t_dist.initialize("localhost:29500", 1, 0, backend="gloo")
    assert not (tmp_path / "r").exists()
