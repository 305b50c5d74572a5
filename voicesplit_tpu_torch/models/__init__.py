"""The mask network (train and eval mode) and its BiLSTM."""
