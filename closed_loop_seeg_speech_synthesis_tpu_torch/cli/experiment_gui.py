"""Patient-facing stimulus presentation (twin of ``experiment/singleWords.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/experiment_gui.py``.  A
tkinter window prompts words (2 s word + 1 s fixation cross, 100 trials by
default) and publishes markers ``experimentStarted`` / ``start;<word>`` /
``end;<word>`` / ``experimentEnded`` on the marker stream.  The word
sequence is drawn from ``random.Random(seed)``, as the JAX package draws it.
Runs headless (``--no-gui``) for loopback testing without a display;
tkinter is imported only for the window.
"""

from __future__ import annotations

import argparse
import logging
import random
import time

from ..runtime.streams import StreamOutlet, local_clock

logger = logging.getLogger("cli.experiment_gui")


def run_experiment(words, n_trials=100, word_seconds=2.0, cross_seconds=1.0,
                   stream_name="SingleWordsMarkerStream", backend=None, gui=True,
                   seed=None, wait_for_consumers=0.0):
    """Present ``n_trials`` words drawn from ``words`` and publish the markers;
    returns the word sequence.  ``wait_for_consumers``: seconds to wait for a
    subscriber before the first marker."""
    outlet = StreamOutlet(stream_name, "Markers", 1, 0.0, string_fmt=True, backend=backend)
    if wait_for_consumers:
        deadline = time.time() + wait_for_consumers
        while not outlet.have_consumers() and time.time() < deadline:
            time.sleep(0.02)
    rng = random.Random(seed)
    sequence = [words[rng.randrange(len(words))] for _ in range(n_trials)]

    root = label = None
    if gui:
        import tkinter as tk

        root = tk.Tk()
        root.title("Single Words")
        root.configure(bg="black")
        root.attributes("-fullscreen", True)
        label = tk.Label(root, text="+", font=("Helvetica", 96), fg="white", bg="black")
        label.pack(expand=True)
        root.update()

    def show(text):
        if label is not None:
            label.config(text=text)
            root.update()

    outlet.push_sample("experimentStarted", local_clock())
    try:
        for word in sequence:
            show(word)
            outlet.push_sample(f"start;{word}", local_clock())
            time.sleep(word_seconds)
            outlet.push_sample(f"end;{word}", local_clock())
            show("+")
            time.sleep(cross_seconds)
    finally:
        outlet.push_sample("experimentEnded", local_clock())
        if root is not None:
            root.destroy()
    return sequence


def main(argv=None):
    parser = argparse.ArgumentParser("Single-word stimulus presentation.")
    parser.add_argument("wordlist", help="Path to a word list (one word per line).")
    parser.add_argument("--trials", type=int, default=100)
    parser.add_argument("--no-gui", action="store_true")
    parser.add_argument("--backend", choices=["lsl", "nsx"], default=None)
    parser.add_argument("--word_seconds", type=float, default=2.0)
    parser.add_argument("--cross_seconds", type=float, default=1.0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    with open(args.wordlist) as f:
        words = [w.strip() for w in f if w.strip()]
    logger.info("%d words loaded", len(words))
    return run_experiment(words, n_trials=args.trials, word_seconds=args.word_seconds,
                          cross_seconds=args.cross_seconds, backend=args.backend,
                          gui=not args.no_gui)


if __name__ == "__main__":
    main()
