"""Recording loaders (twin of reference ``local/data_loader.py``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/io/loaders.py``, reading and
writing HDF5 through the port's own ``io.hdf5`` (no h5py).  HDF5 layout:
datasets ``sEEG`` (T, C), ``Audio`` (Ta,), scalar ``sEEG_sr`` /
``Audio_sr``, optional ``ch_names`` (bytes) and ``markers``
(data_loader.py:16-35).  XDF recordings carry a
``Micromed`` EEG stream, an ``AudioCaptureWin`` stream and a marker stream;
the experiment span is cut between the ``experimentStarted`` /
``experimentEnded`` markers by nearest-timestamp search
(data_loader.py:39-110).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from . import hdf5
from . import xdf as xdf_mod

logger = logging.getLogger("io.loaders")


def load_hdf5(path, return_markers=False):
    with hdf5.File(path, "r") as hf:
        eeg = hf["sEEG"][:]
        audio = hf["Audio"][:].astype(np.float64)
        eeg_sr = int(np.asarray(hf["sEEG_sr"]).reshape(-1)[0])
        audio_sr = int(np.asarray(hf["Audio_sr"]).reshape(-1)[0])
        if "ch_names" in hf:
            ch_names = [c.decode("utf-8") if isinstance(c, bytes) else str(c) for c in hf["ch_names"][:]]
        else:
            ch_names = ["ch_{:03d}".format(i) for i in range(eeg.shape[1])]
        markers = None
        if return_markers and "markers" in hf:
            markers = [[m[0].decode("utf-8") if isinstance(m[0], bytes) else str(m[0])] for m in hf["markers"][:]]
    if return_markers:
        return eeg, eeg_sr, audio, audio_sr, ch_names, markers
    return eeg, eeg_sr, audio, audio_sr, ch_names


def save_hdf5(path, eeg, eeg_sr, audio, audio_sr, ch_names=None, markers=None):
    """Writer for the same layout (used by tests / the dev streamer)."""
    with hdf5.File(path, "w") as hf:
        hf.create_dataset("sEEG", data=np.asarray(eeg))
        hf.create_dataset("Audio", data=np.asarray(audio))
        hf.create_dataset("sEEG_sr", data=int(eeg_sr), dtype=np.int32)
        hf.create_dataset("Audio_sr", data=int(audio_sr), dtype=np.int32)
        if ch_names is not None:
            hf.create_dataset("ch_names", data=np.asarray([c.encode() for c in ch_names]))
        if markers is not None:
            hf.create_dataset("markers", data=np.asarray([[str(m[0]).encode()] for m in markers]))


def _nearest(ts_array, t):
    """Index of the timestamp nearest to t (data_loader.py locate_pos)."""
    pos = int(np.searchsorted(ts_array, t, side="right"))
    if pos == 0:
        return 0
    if pos == len(ts_array):
        return len(ts_array) - 1
    return pos if abs(ts_array[pos] - t) < abs(ts_array[pos - 1] - t) else pos - 1


def _index_streams(streams):
    by_name, marker_name = {}, None
    for i, s in enumerate(streams):
        by_name[s["info"]["name"][0]] = i
        if s["info"]["type"][0] == "Markers":
            marker_name = s["info"]["name"][0]
    return by_name, marker_name


def load_xdf_recording(path, return_markers=False, eeg_stream="Micromed", audio_stream="AudioCaptureWin"):
    streams, _ = xdf_mod.load_xdf(path)
    by_name, marker_name = _index_streams(streams)

    eeg_s = streams[by_name[eeg_stream]]
    aud_s = streams[by_name[audio_stream]]
    mk_s = streams[by_name[marker_name]]

    eeg, eeg_ts = np.asarray(eeg_s["time_series"]), eeg_s["time_stamps"]
    eeg_sr = int(float(eeg_s["info"]["nominal_srate"][0]))
    ch_names = [c["label"][0] for c in eeg_s["info"]["desc"][0]["channels"][0]["channel"]]
    audio, audio_ts = np.asarray(aud_s["time_series"], np.float64), aud_s["time_stamps"]
    audio_sr = int(float(aud_s["info"]["nominal_srate"][0]))
    markers, marker_ts = mk_s["time_series"], mk_s["time_stamps"]

    i = 0
    while markers[i][0] != "experimentStarted":
        i += 1
    eeg_start = _nearest(eeg_ts, marker_ts[i])
    audio_start = _nearest(audio_ts, eeg_ts[eeg_start])
    while markers[i][0] != "experimentEnded":
        i += 1
    eeg_end = _nearest(eeg_ts, marker_ts[i])
    audio_end = _nearest(audio_ts, eeg_ts[eeg_end])
    markers = markers[:i]

    eeg = eeg[eeg_start:eeg_end]
    audio = audio[audio_start:audio_end, 0] if audio.ndim == 2 else audio[audio_start:audio_end]
    if return_markers:
        return eeg, eeg_sr, audio, audio_sr, ch_names, markers
    return eeg, eeg_sr, audio, audio_sr, ch_names


def load_only_eeg(path, eeg_stream="Micromed"):
    """EEG-only cut of an other-task XDF (data_loader.py:113-172) — used for
    exp2's chance-level segments."""
    streams, _ = xdf_mod.load_xdf(path)
    by_name, marker_name = _index_streams(streams)
    eeg_s = streams[by_name[eeg_stream]]
    mk_s = streams[by_name[marker_name]]
    eeg, eeg_ts = np.asarray(eeg_s["time_series"]), eeg_s["time_stamps"]
    eeg_sr = int(float(eeg_s["info"]["nominal_srate"][0]))
    ch_names = [c["label"][0] for c in eeg_s["info"]["desc"][0]["channels"][0]["channel"]]
    markers, marker_ts = mk_s["time_series"], mk_s["time_stamps"]
    i = 0
    while markers[i][0] != "experimentStarted":
        i += 1
    start = _nearest(eeg_ts, marker_ts[i])
    while markers[i][0] != "experimentEnded":
        i += 1
    end = _nearest(eeg_ts, marker_ts[i])
    return eeg[start:end], eeg_sr, ch_names


def load_speech_file(path, return_markers=False):
    """Extension dispatch (data_loader.py:175-193)."""
    ext = os.path.splitext(path)[1][1:].lower()
    if ext in ("h5", "hdf", "hdf5"):
        return load_hdf5(path, return_markers)
    if ext in ("xdf", "xdfz"):
        return load_xdf_recording(path, return_markers)
    raise ValueError(f"unknown recording format: .{ext}")
