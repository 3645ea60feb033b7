"""Character-level LSTM language model + streaming sampling (counterpart
of the JAX package's ``examples/char_rnn_shakespeare.py``).

DL4J analog: `GravesLSTMCharModellingExample` — stacked GravesLSTM with
truncated BPTT, then `rnnTimeStep` for one-char-at-a-time generation.

Run: python -m deeplearning4j_tpu_torch.examples.char_rnn_shakespeare [--smoke] [--device cpu]
"""
import numpy as np

from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TEXT = ("the quick brown fox jumps over the lazy dog. "
        "pack my box with five dozen liquor jugs. ") * 50


def batches(text, vocab, idx, batch, seq_len, rng):
    """One-hot [b, t, v] inputs with next-char one-hot labels."""
    enc = np.array([idx[c] for c in text], dtype=np.int32)
    starts = rng.integers(0, len(enc) - seq_len - 1, size=batch)
    windows = np.stack([enc[s:s + seq_len + 1] for s in starts])
    eye = np.eye(len(vocab), dtype=np.float32)
    return eye[windows[:, :-1]], eye[windows[:, 1:]]


def main(smoke: bool = False, device="cuda"):
    vocab = sorted(set(TEXT))
    idx = {c: i for i, c in enumerate(vocab)}
    hidden, steps, seq_len = (32, 8, 16) if smoke else (256, 300, 64)

    conf = char_rnn_lstm(len(vocab), hidden=hidden, layers=2,
                         tbptt_length=seq_len)
    net = MultiLayerNetwork(conf, device=device).init()

    rng = np.random.default_rng(0)
    for step in range(steps):
        x, y = batches(TEXT, vocab, idx, 32, seq_len, rng)
        loss = net.fit_batch(x, y)
        if step % 50 == 0:
            print(f"step {step}: loss {float(loss):.3f}")

    # streaming generation, one character at a time (rnnTimeStep)
    net.rnn_clear_previous_state()
    eye = np.eye(len(vocab), dtype=np.float32)
    cur = eye[[idx["t"]]]
    out = ["t"]
    for _ in range(60):
        probs = net.rnn_time_step(cur).double().cpu().numpy()[0]
        c = int(rng.choice(len(vocab), p=probs / probs.sum()))
        out.append(vocab[c])
        cur = eye[[c]]
    print("sampled:", "".join(out))


if __name__ == "__main__":
    run(main, __doc__)
