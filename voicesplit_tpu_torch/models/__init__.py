"""Eval-mode mask network and its BiLSTM."""
