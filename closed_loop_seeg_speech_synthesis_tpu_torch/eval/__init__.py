"""Evaluation: the quality metrics and experiment 1 (10-fold retrain+decode
against a randomized chance level).  Experiments 2-4 and the figures are not
ported yet."""
