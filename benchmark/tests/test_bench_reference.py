"""The plain references against the program at tiny sizes on the CPU, both
in float32 on the same weights and batch: the training loss and every
parameter's gradient; and the control's arithmetic off float32 but near
it."""

import pytest
import torch

import _tiny
from harness import common, traffic
from reference import precision


def _both(name):
    cell = _tiny.cell(name)
    cfg = dict(cell.config, program=dict(cell.config["program"],
                                         dtype="float32"))
    fam = common.family(cfg)
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    conf = fam.port_conf(cfg)
    shapes = common.program_shapes(conf)
    net = ComputationGraph(conf, device="cpu")
    net.set_params(common.make_params(fam, cfg, shapes, 5, "cpu"))
    x, y = (torch.as_tensor(a) for a in
            traffic.FitBatches(cell.traffic, cfg, 5, torch.device("cpu"))(0))
    loss, grads = net._loss_and_grads([x], [y], None)
    params = common.make_params(fam, cfg, shapes, 5, "cpu")
    leaves = [(v, k, p.requires_grad_(True)) for v, ps in params.items()
              for k, p in ps.items()]
    ref = fam.summed_loss(fam.logits(params, x, cfg,
                                     precision.Arithmetic("f32")), y) / len(x)
    ref_grads = torch.autograd.grad(ref, [p for _, _, p in leaves])
    return loss, grads, ref, leaves, ref_grads


@pytest.mark.parametrize("name", ["opt-125m.train.t2048",
                                  "resnet50-f32.train.b128"])
def test_reference_matches_program_in_f32(name):
    loss, grads, ref, leaves, ref_grads = _both(name)
    assert float(loss) == pytest.approx(float(ref.detach()), rel=1e-5)
    for (v, k, _), g in zip(leaves, ref_grads):
        scale = float(g.abs().max()) + 1e-12
        err = float((grads[v][k] - g).abs().max())
        assert err <= 1e-4 * scale, f"{v}.{k}: {err} of {scale}"


def test_e4m3_arithmetic_rounds_products():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    exact = precision.Arithmetic("f32").matmul(a, a)
    low = precision.Arithmetic("e4m3").matmul(a, a)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1
