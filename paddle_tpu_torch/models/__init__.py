"""Model builders: the transformer LM, the stacked-LSTM classifier, the
MNIST MLP and LeNet convnet, the attention seq2seq (NMT) training graph
and the ResNets."""
