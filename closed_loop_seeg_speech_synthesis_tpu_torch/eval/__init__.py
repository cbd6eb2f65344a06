"""Evaluation: the quality metrics, DTW and the energy VAD, experiments 1-4
(10-fold retrain+decode against a randomized chance level; DTW correlations
of decoding runs against chance; voiced speech inside and outside trials;
LDA activation maps) and the paper figures."""
