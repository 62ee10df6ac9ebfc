"""Model builders: the transformer LM, the stacked-LSTM classifier and
the MNIST MLP."""
