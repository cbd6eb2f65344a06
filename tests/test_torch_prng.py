"""The port's Griffin-Lim inits are the JAX package's, bit for bit.

``ops/prng.py`` (PRNGKey, fold_in, threefry2x32) and the block inits of
``ops/griffinlim.py`` against ``jax.random`` and the JAX package's
``default_rand_init``, in float32 and float64; then every entry point with
default arguments on both sides (no inits passed in by hand) against its
JAX counterpart in float64 on the CPU: spectrograms bit-equal (or, through
a retrained LDA, on >= 99.9% of entries, as tests/test_torch_exp1.py holds
them), audio within 1 int16 LSB (docs/NUMERICS.md), the exact-host
vocoder's bytes equal.
"""

import configparser
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.io import wavfile

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.eval import exp2 as j_exp2
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import online as j_online
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp2 as t_exp2
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng, prng
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import distributed as t_dist
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

# the exp1 and exp2 sessions (module fixtures) and their experiment pairs
from test_torch_exp1 import N_WORDS as EXP1_WORDS
from test_torch_exp1 import SPEC_ATOL, SPEC_RTOL, AGREE_MIN, session
from test_torch_exp1 import _pair as exp1_pair
from test_torch_exp2 import RUNS as EXP2_RUNS
from test_torch_exp2 import _pair as exp2_pair
from test_torch_exp2 import workspace

DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Step-sized torch ops run inline on one thread (a loaded test machine
    leaves the others unscheduled).  Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(key):
    return tuple(int(w) for w in jax.random.key_data(key))


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_threefry_partitionable_is_on():
    """The port reproduces the partitionable bit layout, JAX's default: a
    JAX upgrade or setting that changes it must fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, -3, 2**63 - 1])
def test_prngkey_matches_jax(seed):
    assert prng.PRNGKey(seed) == _words(jax.random.PRNGKey(seed))
    assert prng.as_key(seed) == prng.PRNGKey(seed)
    assert prng.as_key(prng.PRNGKey(seed)) == prng.PRNGKey(seed)
    assert prng.as_key(np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))) == \
        prng.PRNGKey(seed)


def test_prngkey_overflow_raises_as_jax():
    for seed in (2**63, -(2**63) - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng.PRNGKey(seed)


@pytest.mark.parametrize("data", [0, 1, 479, 181_000, 2**32 - 1])
def test_fold_in_matches_jax(data):
    for seed in (0, 7, -3):
        key = jax.random.PRNGKey(seed)
        want = _words(jax.random.fold_in(key, data))
        assert prng.fold_in(seed, data) == want
        assert prng.fold_in(_words(key), data) == want


def test_fold_in_overflow_raises_as_jax():
    for data in (2**32, 2**40):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(0), data)
        with pytest.raises(OverflowError):
            prng.fold_in(0, data)
    with pytest.raises(ValueError, match="two 32-bit words"):
        prng.as_key((1, 2, 3))


@pytest.mark.parametrize("first", [0, 3, 179_990])
@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_default_rand_init_matches_jax(dtype, jdtype, first):
    """default_rand_init against the JAX package's for seeds 0 and 7 and the
    keys exp1 derives (fold_in(PRNGKey(0), k), the chance level's
    fold_in(key, f * 100003 + start)), as int seeds and as key pairs."""
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(7),
                jax.random.fold_in(jax.random.PRNGKey(0), 3),
                jax.random.fold_in(jax.random.PRNGKey(0), 1 * 100003 + 20)):
        want = j_gl.default_rand_init(key, 5, first, jdtype)
        _bits_equal(t_gl.default_rand_init(5, first, _words(key), dtype), want)
    _bits_equal(t_gl.default_rand_init(5, first, 7, dtype),
                j_gl.default_rand_init(jax.random.PRNGKey(7), 5, first, jdtype))


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_block_rand_clamps_and_wraps_as_the_jax_step(dtype, jdtype):
    """block_rand of any int64 ids: negatives clamp to block 0 (the online
    step's jnp.maximum(i, 0)), ids up to 2^31 - 1, an id past 2^32 wraps as
    JAX's uint32 conversion of a traced integer does."""
    ids = np.array([-5, -1, 0, 1, 2**31 - 1, 2**32 + 9, 179_999], np.int64)
    key = jax.random.PRNGKey(11)
    step_draw = jax.jit(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(key, jnp.maximum(i, 0)), (480,), jdtype)))
    want = step_draw(jnp.asarray(ids))
    got = t_gl.block_rand(torch.as_tensor(ids), 11, dtype)
    _bits_equal(got, want)


def test_block_inits_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_prng.block_inits(torch.zeros(3, dtype=torch.int64, device="meta"), 0, 480,
                              torch.float32)


# ---------------------------------------------------------------------------
# Every entry point, default arguments on both sides
# ---------------------------------------------------------------------------


def _arrays(rng, C, n_feats=16):
    return dict(lda_coef=rng.randn(40, 9, n_feats) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:n_feats], bad_channels=np.zeros(0, int))


def _jax_lda(arrs):
    return j_lda.LDAParams(coef=jnp.asarray(arrs["lda_coef"]),
                           intercept=jnp.asarray(arrs["lda_intercept"]),
                           classes=jnp.asarray(arrs["lda_classes"]),
                           valid=jnp.asarray(arrs["lda_valid"]))


def _within_1_lsb(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and len(a) > 0 and a.dtype == b.dtype == np.int16
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _decoders(arrs, sr, P, C):
    jcfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, gl_norm=10.0,
                                dtype=jnp.float64)
    jdec = j_pipe.build_decoder_params(jcfg, _jax_lda(arrs), arrs["medians"], arrs["select"])
    loaded = t_params.from_arrays(**arrs)
    cfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, gl_norm=10.0,
                               dtype=torch.float64)
    dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                      device="cpu")
    return (jcfg, jdec), (cfg, dec)


def test_offline_decode_default_inits_match_jax(rng):
    """offline_decode with no key and no inits on either side: the
    spectrogram bit-equal, the audio within 1 LSB."""
    C, sr = 5, 1024.0
    arrs = _arrays(rng, C)
    eeg = rng.randn(int(sr * 3), C) * 10.0
    (jcfg, jdec), (cfg, dec) = _decoders(arrs, sr, 32, C)
    spec_j, audio_j = j_pipe.offline_decode(jdec, jcfg, jnp.asarray(eeg))
    spec_t, audio_t = t_pipe.offline_decode(dec, cfg, eeg)
    np.testing.assert_array_equal(spec_t.numpy(), np.asarray(spec_j))
    _within_1_lsb(audio_t.numpy(), audio_j)


def test_online_decoder_default_key_matches_jax(rng):
    """OnlineDecoder over 120 packets at 1024 Hz / 32 samples against the JAX
    OnlineDecoder with its default key PRNGKey(0); then the same packets
    through the persistent decoder's CPU host loop, bit-equal to the port's
    OnlineDecoder."""
    C, sr, P, n = 4, 1024.0, 32, 120
    arrs = _arrays(rng, C)
    packets = [rng.randn(P, C) * 10.0 for _ in range(n)]
    (jcfg, jdec), (cfg, dec) = _decoders(arrs, sr, P, C)
    jd, td = j_online.OnlineDecoder(jcfg, jdec), t_online.OnlineDecoder(cfg, dec)
    for p in packets:
        jd.process_packet(p)
        td.process_packet(p)
    spec_j, audio_j, _ = (np.asarray(a) for a in jd.results())
    spec_t, audio_t, _ = td.results()
    assert spec_t.shape == spec_j.shape and len(spec_t) > 100
    np.testing.assert_allclose(spec_t, spec_j, rtol=1e-9, atol=1e-11)
    _within_1_lsb(audio_t, audio_j)

    pers = t_online.PersistentOnlineDecoder(cfg, dec)
    for p in packets:
        pers.feed_packet(p)
    pers.feed_stop()
    spec_p, audio_p, _ = pers.run_until_stopped()
    np.testing.assert_array_equal(spec_p, spec_t)
    np.testing.assert_array_equal(audio_p, audio_t)


@pytest.fixture
def decode_ws(tmp_path):
    """A params.h5, a 3 s replay file and an experiment.ini for the CLIs."""
    import h5py

    rng = np.random.RandomState(31)
    C = 4
    session_dir = tmp_path / "storage" / "demo"
    session_dir.mkdir(parents=True)
    arrs = _arrays(rng, C, n_feats=12)
    with h5py.File(session_dir / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
        hf.create_dataset("medians_array", data=arrs["medians"])
        hf.create_dataset("select", data=arrs["select"].astype(np.int64))
        for name in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid"):
            hf.create_dataset(name, data=arrs[name])
    seeg_file = tmp_path / "replay.hdf"
    with h5py.File(seeg_file, "w") as hf:
        hf.create_dataset("sEEG", data=rng.randn(3 * 1024, C) * 10.0)
        hf.create_dataset("sEEG_sr", data=1024, dtype=np.int32)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    cfg["Decoding"] = {"stream_name": "x", "griffin_lim_norm": "10", "run": "replay"}
    path = tmp_path / "experiment.ini"
    with open(path, "w") as f:
        cfg.write(f)
    return str(path), str(seeg_file)


@pytest.mark.parametrize("vocoder", ["device", "exact-host"])
def test_decode_cli_default_inits_match_jax(decode_ws, vocoder):
    """``cli decode`` without --rand_init in both packages (float64 on the
    CPU): the spectrogram bit-equal; the exact-host audio byte-equal, the
    device vocoder's within 1 LSB."""
    cfg, seeg = decode_ws
    j_run = j_decode.main([cfg, "--seeg_file", seeg, "--run", "j", "--vocoder", vocoder])
    t_run = t_decode.main([cfg, "--seeg_file", seeg, "--run", "t", "--device", "cpu",
                           "--vocoder", vocoder])
    np.testing.assert_array_equal(np.load(os.path.join(t_run, "spectrogram.npy")),
                                  np.load(os.path.join(j_run, "spectrogram.npy")))
    _, a_t = wavfile.read(os.path.join(t_run, "audio.wav"))
    _, a_j = wavfile.read(os.path.join(j_run, "audio.wav"))
    if vocoder == "exact-host":
        assert a_t.dtype == np.int16 and a_t.tobytes() == a_j.tobytes()
    else:
        _within_1_lsb(a_t, a_j)


def test_exp1_proposed_method_default_inits_match_jax(session, tmp_path):
    """exp1's batched proposed method on 2 folds without rand_inits: fold k
    draws fold_in(PRNGKey(0), k) in both packages, so every word's wav is
    within 1 LSB and pm_reco.npy agrees on >= 99.9% of entries."""
    j, t = exp1_pair(session, tmp_path, 6)
    args = j._construct_datasets_for_run(nb_folds=2)
    j.proposed_method(nb_folds=2, args=args)
    t.proposed_method(nb_folds=2, args=args)
    reco_j = np.load(os.path.join(j.dest_dir, "pm_reco.npy"))
    reco_t = np.load(os.path.join(t.dest_dir, "pm_reco.npy"))
    assert np.isclose(reco_t, reco_j, rtol=SPEC_RTOL, atol=SPEC_ATOL).mean() >= AGREE_MIN
    names = sorted(os.listdir(os.path.join(j.dest_dir, "reco_wavs")))
    assert len(names) == EXP1_WORDS
    for name in names:
        _, wj = wavfile.read(os.path.join(j.dest_dir, "reco_wavs", name))
        _, wt = wavfile.read(os.path.join(t.dest_dir, "reco_wavs", name))
        _within_1_lsb(wt, wj)


def test_exp2_sequential_chance_segments_default_inits_match_jax(workspace, tmp_path,
                                                                  monkeypatch):
    """exp2's sequential chance level: segment i decodes with PRNGKey(i) in
    both packages; each segment's spectrogram (bit-equal) and audio (within
    1 LSB) as ``offline_decode`` returns them inside ``chance_level``."""
    j, t = exp2_pair(workspace, tmp_path, 7)
    seen = {"j": [], "t": []}

    def recording(fn, name):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[name].append(tuple(np.asarray(o) for o in out))
            return out
        return wrapped

    monkeypatch.setattr(j_exp2.pipeline, "offline_decode",
                        recording(j_exp2.pipeline.offline_decode, "j"))
    monkeypatch.setattr(t_exp2.pipeline, "offline_decode",
                        recording(t_exp2.pipeline.offline_decode, "t"))
    j.chance_level(runs=EXP2_RUNS)
    t.chance_level(runs=EXP2_RUNS)
    assert t.rng.cuts == j.rng.cuts and len(seen["t"]) == len(seen["j"]) == EXP2_RUNS
    for (spec_t, audio_t), (spec_j, audio_j) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(spec_t, spec_j)
        _within_1_lsb(audio_t, audio_j)


def test_parallel_dryrun_inputs_match_jax():
    """The replay dryrun's Griffin-Lim inputs: session i's float32 rows of
    PRNGKey(i), as the JAX dryrun draws them (parallel/distributed.py:163)."""
    rand = t_dist.replay_inputs(4)["rand"]
    nf = rand.shape[1] + 1
    want = np.stack([np.asarray(j_gl.default_rand_init(jax.random.PRNGKey(i), nf - 1, 0,
                                                       jnp.float32)) for i in range(4)])
    _bits_equal(rand, want)
