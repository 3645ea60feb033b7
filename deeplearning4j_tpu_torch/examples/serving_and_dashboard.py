"""HTTP model serving + the training dashboard (counterpart of the JAX
package's ``examples/serving_and_dashboard.py``).

DL4J analogs: the Camel serve route (`DL4jServeRouteBuilder`) and the Play
UI server (`UIServer.getInstance().attach(storage)`).

Run: python -m deeplearning4j_tpu_torch.examples.serving_and_dashboard [--smoke] [--device cpu]
"""
import json
import urllib.request

from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.storage import InMemoryStatsStorage
from deeplearning4j_tpu_torch.ui import StatsListener, UIServer


def main(smoke: bool = False, device="cuda"):
    n = 256 if smoke else 10000
    storage = InMemoryStatsStorage()
    net = MultiLayerNetwork(lenet(), device=device).init()
    net.add_listener(StatsListener(storage, collect_histograms=True))
    net.fit(MnistDataSetIterator(batch_size=64, num_examples=n), epochs=1)

    # overview/model/system + histograms
    ui = UIServer(port=0, device=device).attach(storage)
    print(f"dashboard: http://localhost:{ui.port}/")

    x = next(iter(MnistDataSetIterator(batch_size=4, num_examples=8,
                                       train=False))).features
    net.output(x[:1])               # warm up before serving
    srv = InferenceServer(net, device=device)
    try:
        req = urllib.request.Request(
            f"http://localhost:{srv.port}/predict",
            data=json.dumps({"inputs": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            preds = json.loads(resp.read())["outputs"]
        print(f"served {len(preds)} predictions over HTTP")
    finally:
        srv.stop()
        ui.stop()


if __name__ == "__main__":
    run(main, __doc__)
