"""Model builders: the transformer LM, the stacked-LSTM classifier, the
MNIST MLP and the attention seq2seq (NMT) training graph."""
