"""The port's HDF5 codec (``io/hdf5.py``) and estimator pickles against h5py
and sklearn, and the two packages reading each other's files.

Every dtype and shape the system stores goes both ways (codec -> h5py,
h5py -> codec) with equal values; the codec reads h5py's chunked files
(gzip, with and without shuffle, ragged last chunks), leading-axis slices,
groups whose B-tree crosses leaf splits and internal nodes, and refuses what
it does not read with ``NotImplementedError`` naming the feature.
"""

import configparser
import os
import pickle
import tempfile
import types

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.io import loaders as j_loaders
from closed_loop_seeg_speech_synthesis_tpu.io import session as j_session
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.io import hdf5
from closed_loop_seeg_speech_synthesis_tpu_torch.io import loaders as t_loaders
from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as t_session
from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda as t_lda
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params

# what the system stores: recordings, params.h5, a decode run's sEEG.hdf
SYSTEM_DATA = {
    "sEEG": np.random.RandomState(0).randn(300, 7),
    "Audio": np.random.RandomState(1).randn(900).astype(np.float32),
    "sEEG_sr": np.int32(1024),
    "bad_channels": np.zeros(0, np.int64),
    "select": np.arange(5, dtype=np.int64),
    "lda_classes": np.arange(12, dtype=np.int32).reshape(3, 4),
    "lda_valid": np.array([[True, False], [False, True]]),
    "coef3": np.random.RandomState(2).randn(2, 3, 4),
    "estimators": np.void(b"\x80\x04opaque blob\x00\x01"),
    "ch_names": np.array([b"LA1", b"LA12", b"EKG"]),
    "markers": np.array([[b"experimentStarted"], [b"start;w"]]),
    "small": np.arange(-3, 3, dtype=np.int16),
    "bytes": np.arange(5, dtype=np.uint8),
    "big_endian": np.arange(4, dtype=">f8"),
    "scalar_f8": np.float64(2.5),
}


def _write_h5py(path, data):
    with h5py.File(path, "w") as hf:
        for name, value in data.items():
            hf.create_dataset(name, data=value)


def _write_codec(path, data):
    with hdf5.File(path, "w") as hf:
        for name, value in data.items():
            hf.create_dataset(name, data=value)


def _assert_same(reader_a, reader_b, names):
    assert list(reader_a.keys()) == list(reader_b.keys())
    for name in names:
        a, b = reader_a[name], reader_b[name]
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert np.array_equal(np.asarray(a[()]), np.asarray(b[()])), name
        if a.shape:
            assert np.array_equal(a[:2], b[:2]) and np.array_equal(a[1:], b[1:]), name


@pytest.mark.parametrize("writer", ["codec", "h5py"])
def test_system_datasets_round_trip(tmp_path, writer):
    """Codec -> h5py and h5py -> codec: every dataset the system stores, with
    h5py's dtype, shape and values (a scalar's ``[()]`` is a numpy scalar,
    an opaque one a ``np.void``)."""
    path = str(tmp_path / "f.h5")
    (_write_codec if writer == "codec" else _write_h5py)(path, SYSTEM_DATA)
    with h5py.File(path, "r") as hp, hdf5.File(path, "r") as hc:
        _assert_same(hp, hc, SYSTEM_DATA)
        assert type(hc["sEEG_sr"][()]) is np.int32 and type(hc["estimators"][()]) is np.void
        assert hc["estimators"][...].tobytes() == SYSTEM_DATA["estimators"].tobytes()
        assert int(np.asarray(hc["sEEG_sr"]).reshape(-1)[0]) == 1024
        assert "sEEG" in hc and "missing" not in hc and len(hc) == len(SYSTEM_DATA)
        assert hc["lda_valid"].dtype == bool


_DTYPES = ["<f8", "<f4", ">f8", "<i8", "<i4", "<i2", "u1", "bool", "S5", "V3"]


def _values(rs, dtype, shape):
    if dtype == "bool":
        return np.asarray(rs.rand(*shape) > 0.5)
    if dtype.startswith("S"):
        return rs.randint(97, 123, shape + (5,)).astype(np.uint8).view("S5").reshape(shape)
    if dtype.startswith("V"):
        return rs.randint(0, 256, shape + (3,)).astype(np.uint8).view("V3").reshape(shape)
    return np.asarray(rs.randn(*shape) * 100).astype(dtype)


@settings(max_examples=40, deadline=None, database=None)
@given(dtype=st.sampled_from(_DTYPES),
       shape=st.lists(st.integers(0, 4), min_size=0, max_size=3).map(tuple),
       seed=st.integers(0, 2**31 - 1))
def test_round_trip_property(dtype, shape, seed):
    """Any of the system's dtypes at any scalar, empty or 1-3-d shape, both
    ways."""
    value = _values(np.random.RandomState(seed), dtype, shape)
    if dtype.startswith("V") and shape == ():
        value = np.void(value.tobytes())
    with tempfile.TemporaryDirectory() as d:
        for i, write in enumerate((_write_codec, _write_h5py)):
            path = os.path.join(d, f"{i}.h5")
            write(path, {"x": value})
            with h5py.File(path, "r") as hp, hdf5.File(path, "r") as hc:
                _assert_same(hp, hc, ["x"])
                assert np.array_equal(np.asarray(hc["x"][...]), np.asarray(value))


@pytest.mark.parametrize("n", [1, 9, 40, 300])
@pytest.mark.parametrize("writer", ["codec", "h5py"])
def test_groups_of_many_datasets(tmp_path, n, writer):
    """h5py splits the root group's leaf nodes past 8 links and adds an
    internal B-tree level past 32 leaves (300 links); the codec writes one
    leaf node of any size.  Both read back, keys in h5py's order."""
    data = {f"d{i}": np.arange(i % 7, dtype=np.int64) for i in range(n)}
    path = str(tmp_path / "g.h5")
    (_write_codec if writer == "codec" else _write_h5py)(path, data)
    with h5py.File(path, "r") as hp, hdf5.File(path, "r") as hc:
        _assert_same(hp, hc, data)


def test_subgroups_are_walked(tmp_path):
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w") as hf:
        hf.create_group("a").create_group("b").create_dataset("x", data=[1.5, 2.5])
        hf.create_dataset("y", data=3)
    with hdf5.File(path, "r") as hc:
        assert hc.keys() == ["a", "y"] and "a" in hc and "b" not in hc
        assert hc["a"]["b"].keys() == ["x"] and list(hc["a"]["b"]["x"][:]) == [1.5, 2.5]


@pytest.mark.parametrize("shuffle", [False, True])
def test_reads_gzip_chunked_files(tmp_path, shuffle):
    """A lab's recording may come gzip-compressed: chunks that do not divide
    the shape (a ragged last chunk on each axis), a 3-d dataset, a partly
    written one (missing chunks are the fill value), leading-axis slices."""
    rs = np.random.RandomState(3)
    eeg = np.round(rs.randn(1037, 6) * 64) / 64
    path = str(tmp_path / "gz.h5")
    with h5py.File(path, "w") as hf:
        hf.create_dataset("sEEG", data=eeg, chunks=(100, 4), compression="gzip", shuffle=shuffle)
        hf.create_dataset("cube", data=rs.randn(7, 9, 11).astype(">f4"), chunks=(3, 4, 5),
                          compression="gzip", compression_opts=9, shuffle=shuffle)
        hf.create_dataset("part", shape=(40, 3), chunks=(10, 3), dtype="i4", fillvalue=7,
                          compression="gzip", shuffle=shuffle)
        hf["part"][5:12] = 1
    with h5py.File(path, "r") as hp, hdf5.File(path, "r") as hc:
        for name in ("sEEG", "cube", "part"):
            assert np.array_equal(hc[name][()], hp[name][()]), name
            for sl in (slice(0, 3), slice(95, 205), slice(1000, None), slice(-3, None),
                       slice(5, 5)):
                assert np.array_equal(hc[name][sl], hp[name][sl]), (name, sl)
        assert np.array_equal(hc["sEEG"][-1:], eeg[-1:]) and hc["cube"].dtype == ">f4"


def test_contiguous_slice_reads_only_its_rows(tmp_path, monkeypatch):
    """``[a:b]`` of a contiguous dataset reads (b - a) rows from disk; the
    reader takes no other index."""
    eeg = np.random.RandomState(4).randn(1000, 8)
    path = str(tmp_path / "r.h5")
    _write_codec(path, {"sEEG": eeg})
    counts = []
    fromfile = np.fromfile

    def counting(*args, **kwargs):
        counts.append(kwargs["count"])
        return fromfile(*args, **kwargs)

    monkeypatch.setattr(hdf5.np, "fromfile", counting)
    with hdf5.File(path, "r") as hc:
        assert np.array_equal(hc["sEEG"][:10], eeg[:10])
        assert np.array_equal(hc["sEEG"][500:503], eeg[500:503])
    assert counts == [10 * 8, 3 * 8]
    with hdf5.File(path, "r") as hc:
        for key in (3, slice(0, 10, 2), (slice(0, 2), 1)):
            with pytest.raises(TypeError):
                hc["sEEG"][key]


def _refused_file(path, feature):
    if feature == "libver_latest":
        with h5py.File(path, "w", libver="latest") as hf:
            hf.create_dataset("x", data=[1.0])
        return "x", "superblock version 3"
    with h5py.File(path, "w") as hf:
        if feature == "vlen_string":
            hf.create_dataset("x", data=["a", "bb"], dtype=h5py.string_dtype())
            return "x", "variable-length"
        if feature == "lzf":
            hf.create_dataset("x", data=np.arange(100.0), compression="lzf")
            return "x", "filter lzf"
        if feature == "compound":
            hf.create_dataset("x", data=np.zeros(3, [("a", "i4"), ("b", "f8")]))
            return "x", "compound"
        if feature == "soft_link":
            hf.create_dataset("y", data=[1])
            hf["x"] = h5py.SoftLink("/y")
            return "x", "soft links"
    with h5py.File(path, "w", track_order=True) as hf:
        hf.create_dataset("x", data=[1])
    return "x", "version 2 object headers"


@pytest.mark.parametrize("feature", ["libver_latest", "vlen_string", "lzf", "compound",
                                     "soft_link", "track_order"])
def test_unsupported_features_raise(tmp_path, feature):
    path = str(tmp_path / "u.h5")
    name, words = _refused_file(path, feature)
    with pytest.raises(NotImplementedError, match=words):
        with hdf5.File(path, "r") as hc:
            hc[name][()]


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with hdf5.File(str(tmp_path / "w.h5"), "w") as hf:
        with pytest.raises(TypeError):
            hf.create_dataset("u", data=np.array(["unicode"]))
        with pytest.raises(TypeError):
            hf.create_dataset("c", data=np.zeros(2, [("a", "i4")]))
        hf.create_dataset("x", data=1)
        with pytest.raises(ValueError):
            hf.create_dataset("x", data=2)
        with pytest.raises(ValueError):
            hf.create_dataset("g/x", data=2)
    with h5py.File(str(tmp_path / "w.h5"), "r") as hp:
        assert list(hp.keys()) == ["x"] and hp["x"][()] == 1


# ------------------------------------------------------------ the estimators


def _lda_params(seed=5, d=6):
    """40 bins of 9 classes, bin 3 missing two classes, bin 7 binary."""
    rs = np.random.RandomState(seed)
    coef, intercept = rs.randn(40, 9, d), rs.randn(40, 9)
    classes = np.tile(np.arange(9, dtype=np.int32), (40, 1))
    valid = np.ones((40, 9), bool)
    classes[3, :7], classes[3, 7:] = [0, 1, 2, 4, 5, 6, 8], 0
    valid[3, 7:] = False
    classes[7, :2], classes[7, 2:] = [2, 5], 0
    valid[7, 2:] = False
    coef[~valid], intercept[~valid] = 0.0, 0.0
    return coef, intercept, classes, valid


def _t_lda(coef, intercept, classes, valid):
    return t_lda.LDAParams(torch.as_tensor(coef), torch.as_tensor(intercept),
                           torch.as_tensor(classes), torch.as_tensor(valid))


def test_estimators_pickle_is_sklearns():
    """``estimators_pickle`` writes, without sklearn, the bytes ``pickle.dumps``
    gives for ``to_sklearn_estimators`` under the sklearn release it names;
    under sklearn it unpickles to estimators with the same state that predict
    alike, and ``load_estimators`` reads both without sklearn."""
    import sklearn

    params = _t_lda(*_lda_params())
    blob = t_lda.estimators_pickle(params)
    ests = t_lda.to_sklearn_estimators(params)
    if sklearn.__version__ == t_lda.SKLEARN_VERSION:
        assert blob == pickle.dumps(ests)
    X = np.random.RandomState(6).randn(50, 6)
    for mine, ref in zip(pickle.loads(blob), ests):
        assert type(mine) is type(ref) and mine.__dict__.keys() == ref.__dict__.keys()
        for key, value in ref.__dict__.items():
            assert np.array_equal(mine.__dict__[key], value) if isinstance(value, np.ndarray) \
                else mine.__dict__[key] == value, key
        assert np.array_equal(mine.predict(X), ref.predict(X))
    for data in (blob, pickle.dumps(ests)):
        states = t_lda.load_estimators(data)
        assert all(type(s) is t_lda.EstimatorState for s in states)
        back = t_lda.from_sklearn_estimators(states)
        ref = t_lda.from_sklearn_estimators(ests)
        for field in ("coef", "intercept", "classes", "valid"):
            assert torch.equal(getattr(back, field), getattr(ref, field)), field


@pytest.mark.parametrize("payload", ["builtin", "other_class", "protocol_2_bytes"])
def test_load_estimators_refuses_other_globals(payload):
    obj = {"builtin": print, "other_class": configparser.ConfigParser(),
           "protocol_2_bytes": [b"x"]}[payload]
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        t_lda.load_estimators(pickle.dumps(obj, protocol=2 if payload.startswith("protocol")
                                           else pickle.DEFAULT_PROTOCOL))


# ------------------------------------------------- the two packages' files


def _result(coef, intercept, classes, valid, lda):
    rs = np.random.RandomState(8)
    return types.SimpleNamespace(lda=lda, x_train=rs.randn(20, 6), medians=rs.randn(40, 9),
                                 borders=rs.randn(40, 8), select=np.array([4, 0, 9, 2, 7, 1]))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("layout", ["jax", "reference"])
def test_params_files_read_in_both_packages(tmp_path, writer, layout):
    """One package's store_training, the other's load_params: equal in f64.
    ``reference`` drops the ``lda_*`` arrays, as the reference trainer's
    params.h5 has only the pickled blob."""
    arrays = _lda_params()
    if writer == "port":
        path = t_params.store_training(str(tmp_path), _result(*arrays, _t_lda(*arrays)), [2, 5])
    else:
        j = j_lda.LDAParams(*(jnp.asarray(a) for a in arrays))
        path = j_params.store_training(str(tmp_path), _result(*arrays, j), [2, 5])
    if layout == "reference":
        with h5py.File(path, "r") as hf:
            kept = {k: hf[k][()] for k in ("bad_channels", "medians_array", "estimators", "select")}
        _write_h5py(path, kept)
    with open(tmp_path / "LDAs.pkl", "rb") as f:
        with h5py.File(path, "r") as hf:
            assert f.read() == hf["estimators"][()].tobytes()
    p_t = t_params.load_params(path)
    p_j = j_params.load_params(path, dtype=jnp.float64)
    for key in ("medians", "bad_channels", "select"):
        assert np.array_equal(p_t[key], p_j[key]) and p_t[key].dtype == p_j[key].dtype, key
    assert list(p_t["bad_channels"]) == [2, 5]
    for field in ("coef", "intercept", "classes", "valid"):
        t, j = getattr(p_t["lda"], field).numpy(), np.asarray(getattr(p_j["lda"], field))
        assert np.array_equal(t, j) and t.dtype == j.dtype, field
    if layout == "jax":
        assert np.array_equal(p_t["lda"].coef.numpy(), arrays[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recordings_read_in_both_packages(tmp_path, writer):
    """save_hdf5 of one package, load_hdf5 of both (markers and names too)."""
    rs = np.random.RandomState(9)
    eeg, audio = rs.randn(2048, 5), rs.randn(6000)
    names = ["LA1", "LA2", "LB1", "LB2", "EKG"]
    markers = [["experimentStarted"], ["start;w1"], ["end;w1"], ["experimentEnded"]]
    path = str(tmp_path / "speech1.hdf")
    (t_loaders if writer == "port" else j_loaders).save_hdf5(path, eeg, 1024, audio, 48000,
                                                             ch_names=names, markers=markers)
    out_t = t_loaders.load_hdf5(path, return_markers=True)
    out_j = j_loaders.load_hdf5(path, return_markers=True)
    for a, b in zip(out_t, out_j):
        assert (np.array_equal(a, b) and a.dtype == b.dtype) if isinstance(a, np.ndarray) \
            else a == b
    assert np.array_equal(out_t[0], eeg) and out_t[4] == names and out_t[5] == markers


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_decoding_runs_read_in_both_packages(tmp_path, writer):
    """One package's decode artifacts (store_decoding_to_file), both
    packages' DecodingRun: the same sEEG, audio, trials and words."""
    rs = np.random.RandomState(10)
    received = rs.randn(10 * 1024, 4).astype(np.float32)
    audio = (rs.randn(16000 * 10) * 1000).astype(np.int16)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"session": "demo"}
    store = t_decode.store_decoding_to_file if writer == "port" else j_decode.store_decoding_to_file
    store(str(tmp_path), cfg, rs.randn(999, 40), audio, received, 1024)
    np.save(tmp_path / "first_timestamp.npy", np.float64(100.0))
    with open(tmp_path / "markers.csv", "w") as f:
        f.write("0,101.5,start;w1\n0,103.5,end;w1\n0,104.25,start;w2\n")
    run_t, run_j = t_session.DecodingRun(str(tmp_path)), j_session.DecodingRun(str(tmp_path))
    assert np.array_equal(run_t.eeg, received) and run_t.eeg.dtype == run_j.eeg.dtype
    assert np.array_equal(run_t.eeg, run_j.eeg) and run_t.eeg_sr == run_j.eeg_sr == 1024
    assert np.array_equal(run_t.audio, run_j.audio) and run_t.words == run_j.words == ["w1", "w2"]
    assert np.array_equal(run_t.word_starts_indices_eeg, run_j.word_starts_indices_eeg)


# ------------------------------------------------------------ the fixtures

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch")
FIXTURE_FILES = ("params_jax.h5", "params_reference.h5", "recording_gzip.hdf")


def _estimator_values(blob):
    return [{k: v for k, v in s.__dict__.items() if k != "_sklearn_version"}
            for s in t_lda.load_estimators(blob)]


def test_fixtures_match_their_generator(tmp_path):
    """The committed fixtures hold the values that ``make_fixtures.py``
    writes now with h5py and the JAX package (the estimators compared as
    unpickled values, not bytes), so that they cannot go stale."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_fixtures",
                                                  os.path.join(FIXTURES, "make_fixtures.py"))
    make_fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_fixtures)
    make_fixtures.make(str(tmp_path))
    for name in FIXTURE_FILES:
        with hdf5.File(os.path.join(FIXTURES, name), "r") as kept, \
                h5py.File(str(tmp_path / name), "r") as fresh:
            assert kept.keys() == list(fresh.keys()), name
            for key in kept.keys():
                a, b = kept[key], fresh[key]
                assert a.shape == b.shape and (a.dtype == b.dtype or a.dtype.kind == "V"), key
                if key == "estimators":
                    va, vb = (_estimator_values(x[()].tobytes()) for x in (a, b))
                    assert len(va) == len(vb) == 40
                    for sa, sb in zip(va, vb):
                        assert sa.keys() == sb.keys()
                        assert all(np.array_equal(sa[k], sb[k]) for k in sa), key
                else:
                    assert np.array_equal(a[()], b[()]), (name, key)


@pytest.mark.parametrize("name", ["params_jax.h5", "params_reference.h5"])
def test_port_loads_the_fixture_params_as_the_jax_package(name):
    """h5py-written params.h5 (the JAX package's layout and the reference's
    blob-only one): the port's load_params equals the JAX package's."""
    path = os.path.join(FIXTURES, name)
    p_t, p_j = t_params.load_params(path), j_params.load_params(path, dtype=jnp.float64)
    for key in ("medians", "bad_channels", "select"):
        assert np.array_equal(p_t[key], p_j[key]), key
    assert list(p_t["bad_channels"]) == [3] and len(p_t["select"]) == 4
    for field in ("coef", "intercept", "classes", "valid"):
        assert np.array_equal(getattr(p_t["lda"], field).numpy(),
                              np.asarray(getattr(p_j["lda"], field))), field


def test_port_reads_the_gzip_fixture_recording():
    with h5py.File(os.path.join(FIXTURES, "recording_gzip.hdf"), "r") as hp, \
            hdf5.File(os.path.join(FIXTURES, "recording_gzip.hdf"), "r") as hc:
        assert hp["sEEG"].compression == "gzip" and hp["sEEG"].shuffle
        _assert_same(hp, hc, ("sEEG", "sEEG_sr", "ch_names"))
        assert np.array_equal(hc["sEEG"][500:1300], hp["sEEG"][500:1300])
