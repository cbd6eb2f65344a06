"""The port's lab tools over the NSX transport: the headless stimulus run
(``cli.experiment_gui.run_experiment``) draws the JAX package's word
sequence and publishes its marker protocol (singleWords.py:34-62), and the
marker listener (``cli.receive_markers``, a subprocess) prints every label,
from either package's sender, in the JAX package's format."""

import os
import re
import subprocess
import sys
import threading

import pytest

from closed_loop_seeg_speech_synthesis_tpu.cli import experiment_gui as j_gui
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import experiment_gui as t_gui
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime.streams import StreamInlet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["boom", "vis"]
RUN = dict(n_trials=3, word_seconds=0.05, cross_seconds=0.02, backend="nsx", gui=False, seed=1,
           wait_for_consumers=20.0)
LINE = re.compile(r"^-?\d+\.\d{6}  (\S+)$")  # f"{ts + correction:.6f}  {label}"


@pytest.fixture
def registry(tmp_path, monkeypatch):
    path = tmp_path / "nsx"
    path.mkdir()
    monkeypatch.setenv("NSX_REGISTRY_DIR", str(path))
    return path


def _protocol(sequence):
    return (["experimentStarted"] + [f"{p};{w}" for w in sequence for p in ("start", "end")]
            + ["experimentEnded"])


def _listen(name, seen):
    inlet = StreamInlet(name, timeout=20.0, backend="nsx")
    while True:
        label, _ = inlet.pull_string(timeout=1.0)
        if label is not None:
            seen.append(label)
            if label == "experimentEnded":
                return


def test_experiment_gui_matches_jax(registry):
    """Both packages' headless runs with seed 1: the same words, the same
    markers in the same order."""
    runs = {}
    for name, gui in (("jax", j_gui), ("port", t_gui)):
        seen = []
        t = threading.Thread(target=_listen, args=(f"gui_{name}", seen), daemon=True)
        t.start()
        words = gui.run_experiment(WORDS, stream_name=f"gui_{name}", **RUN)
        t.join(timeout=20)
        assert not t.is_alive()
        runs[name] = (words, seen)
    assert runs["port"][0] == runs["jax"][0] and len(runs["port"][0]) == 3
    assert set(runs["port"][0]) <= set(WORDS)
    assert runs["port"][1] == runs["jax"][1] == _protocol(runs["port"][0])


@pytest.mark.parametrize("sender", ["port", "jax"])
def test_receive_markers_prints_every_label(registry, sender):
    """receive_markers.main in a subprocess, subscribed before the run
    starts, prints one line per marker: the timestamp plus the time
    correction to 6 decimals, two spaces, the label."""
    name = f"mk_{sender}"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", "from closed_loop_seeg_speech_synthesis_tpu_torch.cli."
         "receive_markers import main; main()", "--stream_name", name, "--backend", "nsx"],
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.rstrip().endswith("experimentEnded"):
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        words = (t_gui if sender == "port" else j_gui).run_experiment(WORDS, stream_name=name,
                                                                     **RUN)
        reader.join(timeout=20)
        assert not reader.is_alive(), lines
    finally:
        proc.kill()
        proc.wait(timeout=10)
    assert lines[0] == f"listening on {name} (nsx)"
    labels = [LINE.match(line).group(1) for line in lines[1:]]
    assert labels == _protocol(words)
