"""Barnes-Hut t-SNE of learned embeddings (counterpart of the JAX
package's ``examples/tsne_embeddings.py``).

DL4J analog: `BarnesHutTsne` over word vectors (plot package). Trains
DeepWalk embeddings on a small graph, then embeds them in 2-D with t-SNE
(at this size, n ≤ ``dense_threshold``, the exact dense path on the
device; larger inputs take the θ-criterion Barnes-Hut gradient on the
host).

Run: python -m deeplearning4j_tpu_torch.examples.tsne_embeddings [--smoke] [--device cpu]
"""
import numpy as np

from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne


def ring_of_cliques(n_cliques=4, size=6):
    g = Graph(n_cliques * size)
    for c in range(n_cliques):
        base = c * size
        for i in range(size):
            for j in range(i + 1, size):
                g.add_edge(base + i, base + j)
        g.add_edge(base, ((c + 1) % n_cliques) * size)
    return g


def main(smoke: bool = False, device="cuda"):
    g = ring_of_cliques()
    dw = DeepWalk(vector_size=8 if smoke else 32, window_size=3,
                  walk_length=10, walks_per_vertex=4 if smoke else 20,
                  seed=7, device=device)
    dw.fit(g)
    vectors = np.stack([np.asarray(dw.get_vertex_vector(v))
                        for v in range(g.num_vertices())])

    tsne = BarnesHutTsne(n_components=2, theta=0.5, perplexity=5.0,
                         max_iter=50 if smoke else 500, seed=3, device=device)
    emb = np.asarray(tsne.fit_transform(vectors))
    print("embedded:", emb.shape)
    # vertices in the same clique should land nearer each other on average
    same = np.linalg.norm(emb[0] - emb[1])
    other = np.linalg.norm(emb[0] - emb[12])
    print(f"intra-clique dist {same:.2f} vs inter-clique {other:.2f}")


if __name__ == "__main__":
    run(main, __doc__)
