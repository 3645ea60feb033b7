"""Char-RNN LSTM (the reference's third bench config): recurrent training + TBPTT +
streaming inference (the reference's GravesLSTM character-modelling setup)."""

from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import RnnOutputLayer
from ..nn.conf.recurrent import GravesLSTM


def char_rnn_lstm(vocab_size: int, *, hidden: int = 256, layers: int = 2,
                  tbptt_length: int = 50, updater: str = "adam",
                  learning_rate: float = 1e-3, seed: int = 42,
                  dtype: str = "float32"):
    """Stacked GravesLSTM char model as a MultiLayerConfiguration."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .dtype(dtype)
         .list())
    for _ in range(layers):
        b = b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    return (b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                   loss="mcxent"))
            .backprop_type("truncated_bptt")
            .t_bptt_forward_length(tbptt_length)
            .t_bptt_backward_length(tbptt_length)
            .set_input_type(InputType.recurrent(vocab_size))
            .build())
