"""Model builders: the transformer LM, the stacked-LSTM classifier, the
MNIST MLP and LeNet convnet, the attention seq2seq (NMT) training graph,
the ResNets, VGG-16, AlexNet, GoogLeNet and SmallNet, and the
semantic-role tagger (bi-LSTM + CRF)."""
