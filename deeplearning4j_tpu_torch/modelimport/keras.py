"""Keras HDF5 importer (counterpart of the JAX package's
``modelimport/keras.py``).

Parity: reference ``keras/Model.java`` / ``ModelConfiguration.java`` /
``LayerConfiguration.java``. Reads a Keras-saved ``.h5`` archive: the
``model_config`` JSON attribute picks the architecture, ``model_weights``
holds per-layer arrays. Supports Keras 1.x and 2.x sequential configs and
linear/residual functional graphs, imported into the port's
``MultiLayerNetwork`` and ``ComputationGraph`` on ``device`` (``"cuda"``
unless the caller passes ``"cpu"``).

Reading a file (``_weight_group``, ``_layer_arrays``; h5py, imported
lazily) is kept apart from translating its arrays, so
:func:`_import_arrays` imports from a config JSON plus a
``{layer: {name: array}}`` dict with the same code the file path runs.

Supported layers (superset of the reference's ``LayerConfiguration.java:42``):
Dense, Activation, Dropout, Flatten, Convolution2D/Conv2D, MaxPooling2D,
AveragePooling2D, LSTM, Embedding, BatchNormalization.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, EmbeddingLayer, OutputLayer, RnnOutputLayer,
    SubsamplingLayer)
from ..nn.conf.recurrent import (
    GravesLSTM, LastTimeStepLayer, TimeDistributedDenseLayer)

_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "softmax": "softmax",
    "sigmoid": "sigmoid", "tanh": "tanh", "hard_sigmoid": "hardsigmoid",
    "softplus": "softplus", "elu": "elu", "selu": "selu",
    "softsign": "softsign", "leaky_relu": "leakyrelu",
}

# a keras layer name → its arrays keyed by trailing name (kernel/bias/...)
ArraysOf = Callable[[str], Dict[str, np.ndarray]]


def _map_activation(name: Optional[str]) -> str:
    if not name:
        return "identity"
    return _ACTIVATIONS.get(name, name)


def _import_arrays(model_config: dict,
                   weights: Mapping[str, Mapping[str, np.ndarray]], *,
                   loss: str = "mcxent", device="cuda"):
    """Import from a Keras ``model_config`` (dict or JSON string) and the
    arrays a file would hold, ``{layer name: {array name: array}}``
    (array names as :meth:`KerasModelImport._layer_arrays` keys them):
    Sequential → MultiLayerNetwork, anything else → ComputationGraph."""
    if isinstance(model_config, str):
        model_config = json.loads(model_config)

    def arrays_of(lname):
        return {k: np.asarray(v) for k, v in weights.get(lname, {}).items()}

    return KerasModelImport._import(model_config, arrays_of, loss, device)


class KerasModelImport:
    """Static import entry points (parity: ``Model.importSequentialModel``)."""

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @staticmethod
    def import_sequential_model(path: str, *, train: bool = False,
                                loss: str = "mcxent", device="cuda"):
        """h5 → initialized MultiLayerNetwork with imported weights.

        The final Dense layer becomes an OutputLayer with `loss` so the
        returned net is trainable/evaluable (reference enforceTrainingConfig
        analog)."""
        import h5py

        with h5py.File(path, "r") as f:
            model_config = KerasModelImport._read_model_config(f)
            group = KerasModelImport._weight_group(f)
            return KerasModelImport._sequential(
                model_config,
                lambda n: KerasModelImport._layer_arrays(group, n),
                loss, device)

    @staticmethod
    def import_model(path: str, *, train: bool = False, loss: str = "mcxent",
                     device="cuda"):
        """h5 → model, dispatching on the saved architecture class (parity:
        ``Model.importModel`` ``keras/Model.java:95-128``): Sequential →
        MultiLayerNetwork, Model/Functional → ComputationGraph."""
        import h5py

        with h5py.File(path, "r") as f:
            model_config = KerasModelImport._read_model_config(f)
            group = KerasModelImport._weight_group(f)
            return KerasModelImport._import(
                model_config,
                lambda n: KerasModelImport._layer_arrays(group, n),
                loss, device)

    @staticmethod
    def import_functional_model(path: str, *, train: bool = False,
                                loss: str = "mcxent", device="cuda"):
        """h5 functional-API model → initialized ComputationGraph with
        imported weights (parity: ``Model.importFunctionalApiModel``
        ``keras/Model.java:78``).

        Keras merge layers map to graph vertices: Concatenate/Merge(concat) →
        MergeVertex, Add/Merge(sum) → ElementWiseVertex(add), Subtract →
        ElementWiseVertex(subtract), Multiply → ElementWiseVertex(product),
        Average → ElementWiseVertex(average), Maximum → ElementWiseVertex(max).
        Dense layers feeding network outputs become OutputLayers with `loss`
        so the returned graph is trainable/evaluable."""
        import h5py

        with h5py.File(path, "r") as f:
            model_config = KerasModelImport._read_model_config(f)
            group = KerasModelImport._weight_group(f)
            return KerasModelImport._functional(
                model_config,
                lambda n: KerasModelImport._layer_arrays(group, n),
                loss, device)

    @staticmethod
    def import_model_configuration(path_or_json: str, loss: str = "mcxent"):
        """Config-only import: model JSON (file path or string) →
        MultiLayerConfiguration (parity: ``ModelConfiguration``)."""
        if path_or_json.lstrip().startswith("{"):
            model_config = json.loads(path_or_json)
        else:
            with open(path_or_json) as f:
                model_config = json.load(f)
        layer_configs = model_config["config"]
        if isinstance(layer_configs, dict):
            layer_configs = layer_configs["layers"]
        return KerasModelImport._build_sequential_conf(layer_configs, loss)

    # ------------------------------------------------------------------
    # import from a config and an array lookup (file or dict)
    # ------------------------------------------------------------------

    @staticmethod
    def _import(model_config: dict, arrays_of: ArraysOf, loss: str, device):
        if model_config["class_name"] == "Sequential":
            return KerasModelImport._sequential(model_config, arrays_of,
                                                loss, device)
        return KerasModelImport._functional(model_config, arrays_of, loss,
                                            device)

    @staticmethod
    def _sequential(model_config: dict, arrays_of: ArraysOf, loss: str,
                    device):
        from ..nn.multilayer import MultiLayerNetwork

        class_name = model_config["class_name"]
        if class_name != "Sequential":
            raise ValueError(
                f"not a sequential model ({class_name}); use "
                "import_functional_model")
        layer_configs = model_config["config"]
        if isinstance(layer_configs, dict):  # keras 2.3+: {"layers": []}
            layer_configs = layer_configs["layers"]
        conf = KerasModelImport._build_sequential_conf(layer_configs, loss)
        net = MultiLayerNetwork(conf, device=device).init()
        KerasModelImport._load_sequential_weights(arrays_of, net,
                                                  layer_configs)
        return net

    @staticmethod
    def _functional(model_config: dict, arrays_of: ArraysOf, loss: str,
                    device):
        from ..nn.graph_runtime import ComputationGraph

        if model_config["class_name"] == "Sequential":
            raise ValueError("sequential model; use import_sequential_model")
        conf = KerasModelImport._build_functional_conf(
            model_config["config"], loss)
        net = ComputationGraph(conf, device=device).init()
        KerasModelImport._load_graph_weights(arrays_of, net, model_config)
        return net

    # ------------------------------------------------------------------
    # config translation
    # ------------------------------------------------------------------

    @staticmethod
    def _read_model_config(f) -> dict:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ValueError("no model_config attribute — architecture JSON "
                             "required (weights-only files unsupported)")
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8")
        return json.loads(raw)

    @staticmethod
    def _input_type_of(cfg: dict, data_format: str) -> Optional[InputType]:
        shape = cfg.get("batch_input_shape")
        if shape is not None:
            shape = [s for s in shape[1:]]  # drop batch
        elif cfg.get("input_shape") is not None:
            shape = list(cfg["input_shape"])
        elif cfg.get("input_dim") is not None:
            shape = [int(cfg["input_dim"])]
        else:
            return None
        if len(shape) == 1:
            return InputType.feed_forward(int(shape[0]))
        if len(shape) == 2:
            return InputType.recurrent(int(shape[1]),
                                       None if shape[0] is None else int(shape[0]))
        if len(shape) == 3:
            if data_format == "channels_first":
                c, h, w = shape
            else:
                h, w, c = shape
            return InputType.convolutional(int(h), int(w), int(c))
        raise ValueError(f"unsupported input shape {shape}")

    @staticmethod
    def _data_format(cfg: dict) -> str:
        v = cfg.get("data_format") or cfg.get("dim_ordering")
        if v in ("channels_first", "th"):
            return "channels_first"
        return "channels_last"

    @staticmethod
    def _build_sequential_conf(layer_configs: List[dict], loss: str):
        builder = NeuralNetConfiguration.builder().updater("sgd") \
            .learning_rate(0.01).list()
        input_type = None
        entries = []  # (keras_name, our_layer | None)
        last_dense_idx = -1
        for lc in layer_configs:
            cls = lc["class_name"]
            cfg = lc["config"] if "config" in lc else {}
            name = cfg.get("name") or lc.get("name") or cls.lower()
            fmt = KerasModelImport._data_format(cfg)
            if input_type is None:
                it = KerasModelImport._input_type_of(cfg, fmt)
                if it is not None:
                    input_type = it
            layer = KerasModelImport._translate_layer(cls, cfg, fmt)
            if layer is None:
                continue
            layers_out = layer if isinstance(layer, list) else [layer]
            for li, l in enumerate(layers_out):
                # aux layers (e.g. LastTimeStep) carry no keras weights —
                # suffix the name so weight lookup skips them
                entries.append((name if li == 0 else f"{name}__aux{li}",
                                cls if li == 0 else "_Aux", l))
            if cls in ("Dense", "TimeDistributedDense", "TimeDistributed"):
                last_dense_idx = len(entries) - 1
        if last_dense_idx >= 0:
            # final Dense → OutputLayer so the net can train/evaluate
            name, cls, dense = entries[last_dense_idx]
            is_last_param_layer = all(
                c in ("Activation", "Dropout") for _, c, _ in
                entries[last_dense_idx + 1:])
            if is_last_param_layer:
                act = dense.activation
                # a following Activation layer overrides
                for _, c, l in entries[last_dense_idx + 1:]:
                    if c == "Activation":
                        act = l.activation
                entries = entries[:last_dense_idx + 1]
                if cls == "Dense":
                    entries[last_dense_idx] = (name, "Dense", OutputLayer(
                        n_in=dense.n_in, n_out=dense.n_out, activation=act,
                        loss=loss))
                else:
                    # final time-distributed dense → RnnOutputLayer (the
                    # reference's per-timestep output path)
                    entries[last_dense_idx] = (name, cls, RnnOutputLayer(
                        n_in=dense.n_in, n_out=dense.n_out, activation=act,
                        loss=loss))
        lb = builder
        for _, _, layer in entries:
            lb = lb.layer(layer)
        if input_type is not None:
            lb = lb.set_input_type(input_type)
        conf = lb.build()
        conf._keras_layer_names = [n for n, _, _ in entries]
        conf._keras_classes = [c for _, c, _ in entries]
        return conf

    # merge-layer class → vertex factory (keras 2 classes + keras 1 Merge
    # modes; parity: the reference maps these onto MergeVertex /
    # ElementWiseVertex in KerasLayer handling, Model.java:78-128)
    _MERGE_OPS = {"Add": "add", "Subtract": "subtract",
                  "Multiply": "product", "Average": "average",
                  "Maximum": "max"}
    _MERGE1_MODES = {"sum": "add", "mul": "product", "ave": "average",
                     "max": "max"}

    @staticmethod
    def _build_functional_conf(config: dict, loss: str):
        from ..nn.conf.graph import ElementWiseVertex, MergeVertex

        layers = config["layers"]
        output_refs = [o[0] for o in config["output_layers"]]
        input_refs = [i[0] for i in config["input_layers"]]

        builder = (NeuralNetConfiguration.builder().updater("sgd")
                   .learning_rate(0.01).graph_builder())
        builder.add_inputs(*input_refs)

        alias: Dict[str, str] = {}   # keras name → actual vertex name
        input_types: Dict[str, InputType] = {}
        classes_by_name: Dict[str, str] = {}

        def resolve(name: str) -> str:
            while name in alias:
                name = alias[name]
            return name

        for lc in layers:
            cls = lc["class_name"]
            cfg = lc.get("config", {})
            name = lc.get("name") or cfg.get("name") or cls.lower()
            fmt = KerasModelImport._data_format(cfg)
            nodes = lc.get("inbound_nodes") or []
            in_names = [resolve(ref[0]) for ref in (nodes[0] if nodes else [])]

            if cls == "InputLayer":
                it = KerasModelImport._input_type_of(cfg, fmt)
                if it is not None:
                    input_types[name] = it
                continue

            if cls == "Concatenate" or (
                    cls == "Merge" and cfg.get("mode", "concat") == "concat"):
                builder.add_vertex(name, MergeVertex(), *in_names)
                classes_by_name[name] = cls
                continue
            if cls in KerasModelImport._MERGE_OPS or cls == "Merge":
                op = (KerasModelImport._MERGE_OPS.get(cls)
                      or KerasModelImport._MERGE1_MODES.get(cfg.get("mode")))
                if op is None:
                    raise ValueError(
                        f"unsupported Merge mode {cfg.get('mode')!r}")
                builder.add_vertex(name, ElementWiseVertex(op=op), *in_names)
                classes_by_name[name] = cls
                continue

            layer = KerasModelImport._translate_layer(cls, cfg, fmt)
            if layer is None:           # Flatten etc: pass-through alias
                alias[name] = in_names[0]
                continue
            if name in output_refs and cls == "Dense":
                # Dense at a network output → OutputLayer (trainable graph)
                layer = OutputLayer(n_out=layer.n_out,
                                    activation=layer.activation, loss=loss)
            layers_out = layer if isinstance(layer, list) else [layer]
            prev = in_names
            for li, l in enumerate(layers_out):
                vname = name if li == 0 else f"{name}__aux{li}"
                builder.add_layer(vname, l, *prev)
                classes_by_name[vname] = cls if li == 0 else "_Aux"
                prev = [vname]
            if len(layers_out) > 1:
                alias[name] = prev[0]   # downstream consumers see the aux tail
                classes_by_name[name] = cls  # weights live under keras name

        builder.set_outputs(*[resolve(o) for o in output_refs])
        if input_types:
            missing = [i for i in input_refs if i not in input_types]
            if missing:
                # positional set_input_types would silently assign shapes to
                # the wrong inputs — fail loudly instead
                raise ValueError(
                    f"InputLayer(s) {missing} declare no input shape while "
                    f"{sorted(input_types)} do; cannot infer input types")
            builder.set_input_types(*[input_types[i] for i in input_refs])
        conf = builder.build()
        conf._keras_classes_by_name = classes_by_name
        return conf

    @staticmethod
    def _merge_translated_weights(net, key, lname: str, p: dict) -> None:
        """Write translated keras arrays into net.params[key] in place
        (running mean/var into net.state) with shape validation. Shared by
        the sequential and functional loaders. The tensors stay the same
        objects, so the optimizer state and anything else that aliases
        them keeps seeing the net's parameters."""
        cur = net.params[key]
        with torch.no_grad():
            for pname, arr in p.items():
                where = net.state.get(key, {}) if pname in ("mean", "var") \
                    else cur
                target = where.get(pname)
                if target is None:
                    raise ValueError(
                        f"{lname}/{pname}: the layer has no {pname!r} (it "
                        f"has {sorted(where)})")
                if tuple(target.shape) != tuple(np.shape(arr)):
                    raise ValueError(
                        f"{lname}/{pname}: shape {tuple(np.shape(arr))} != "
                        f"expected {tuple(target.shape)}")
                target.copy_(torch.from_numpy(np.array(arr)))

    @staticmethod
    def _load_graph_weights(arrays_of: ArraysOf, net,
                            model_config: dict) -> None:
        """Copy keras weights into ComputationGraph params by VERTEX NAME
        (functional models address layers by name, reference Model.java:110)."""
        classes = net.conf._keras_classes_by_name
        fmt_by_name = {}
        for lc in model_config["config"]["layers"]:
            c = lc.get("config", {})
            n = lc.get("name") or c.get("name")
            fmt_by_name[n] = KerasModelImport._data_format(c)
        for vname in net.topo_order:
            cls = classes.get(vname)
            if cls in (None, "_Aux"):
                continue
            arrays = arrays_of(vname)
            if not arrays:
                continue
            p = KerasModelImport._translate_weights(
                cls, arrays, vname, fmt_by_name.get(vname, "channels_last"))
            if p:
                KerasModelImport._merge_translated_weights(net, vname, vname, p)

    @staticmethod
    def _translate_layer(cls: str, cfg: dict, fmt: str):
        act = _map_activation(cfg.get("activation"))
        if cls == "Dense":
            n_out = cfg.get("units") or cfg.get("output_dim")
            return DenseLayer(n_out=int(n_out), activation=act)
        if cls in ("Convolution2D", "Conv2D"):
            n_out = cfg.get("filters") or cfg.get("nb_filter")
            ks = cfg.get("kernel_size") or (cfg.get("nb_row"), cfg.get("nb_col"))
            stride = cfg.get("strides") or cfg.get("subsample") or (1, 1)
            pad = cfg.get("padding") or cfg.get("border_mode") or "valid"
            return ConvolutionLayer(n_out=int(n_out),
                                    kernel_size=tuple(int(k) for k in ks),
                                    stride=tuple(int(s) for s in stride),
                                    border_mode=str(pad), activation=act)
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            ks = cfg.get("pool_size") or (2, 2)
            stride = cfg.get("strides") or ks
            pad = cfg.get("padding") or cfg.get("border_mode") or "valid"
            return SubsamplingLayer(
                pooling_type="max" if cls == "MaxPooling2D" else "avg",
                kernel_size=tuple(int(k) for k in ks),
                stride=tuple(int(s) for s in stride), border_mode=str(pad))
        if cls == "LSTM":
            n_out = cfg.get("units") or cfg.get("output_dim")
            lstm = GravesLSTM(
                n_out=int(n_out), activation=act if act != "identity" else "tanh",
                gate_activation=_map_activation(
                    cfg.get("recurrent_activation")
                    or cfg.get("inner_activation") or "hard_sigmoid"))
            if not cfg.get("return_sequences", False):
                return [lstm, LastTimeStepLayer()]
            return lstm
        if cls == "TimeDistributedDense":  # keras 1
            n_out = cfg.get("units") or cfg.get("output_dim")
            return TimeDistributedDenseLayer(n_out=int(n_out), activation=act)
        if cls == "TimeDistributed":  # keras 2 wrapper
            inner = cfg.get("layer") or {}
            if inner.get("class_name") != "Dense":
                raise ValueError(
                    "only TimeDistributed(Dense) import is supported, got "
                    f"TimeDistributed({inner.get('class_name')!r})")
            icfg = inner.get("config", {})
            n_out = icfg.get("units") or icfg.get("output_dim")
            return TimeDistributedDenseLayer(
                n_out=int(n_out),
                activation=_map_activation(icfg.get("activation")))
        if cls == "Embedding":
            return EmbeddingLayer(n_in=int(cfg["input_dim"]),
                                  n_out=int(cfg["output_dim"]),
                                  activation="identity", has_bias=False)
        if cls == "BatchNormalization":
            return BatchNormalization(eps=float(cfg.get("epsilon", 1e-5)),
                                      decay=float(cfg.get("momentum", 0.9)))
        if cls == "Activation":
            return ActivationLayer(activation=act)
        if cls == "Dropout":
            return DropoutLayer(dropout=float(cfg.get("rate", cfg.get("p", 0.0))))
        if cls in ("Flatten", "InputLayer"):
            return None  # shape handling is automatic (preprocessors)
        raise ValueError(f"unsupported Keras layer type {cls!r}")

    # ------------------------------------------------------------------
    # reading a file
    # ------------------------------------------------------------------

    @staticmethod
    def _weight_group(f):
        return f["model_weights"] if "model_weights" in f else f

    @staticmethod
    def _layer_arrays(group, lname: str) -> Dict[str, np.ndarray]:
        """All arrays under a keras layer group, keyed by trailing name
        (kernel/bias/...); falls back to keras-1 style flat names."""
        if lname not in group:
            return {}
        g = group[lname]
        out = {}

        def visit(name, obj):
            import h5py
            if isinstance(obj, h5py.Dataset):
                key = name.split("/")[-1].split(":")[0]
                out[key] = np.asarray(obj)
        g.visititems(visit)
        return out

    # ------------------------------------------------------------------
    # weight translation
    # ------------------------------------------------------------------

    @staticmethod
    def _load_sequential_weights(arrays_of: ArraysOf, net,
                                 layer_configs) -> None:
        names = net.conf._keras_layer_names
        classes = net.conf._keras_classes
        for i, (lname, cls) in enumerate(zip(names, classes)):
            arrays = arrays_of(lname)
            if not arrays:
                continue
            key = f"layer_{i}"
            fmt = "channels_last"
            for lc in layer_configs:
                c = lc.get("config", {})
                if (c.get("name") or lc.get("name")) == lname:
                    fmt = KerasModelImport._data_format(c)
            p = KerasModelImport._translate_weights(cls, arrays, lname, fmt)
            if p:
                KerasModelImport._merge_translated_weights(net, key, lname, p)

    @staticmethod
    def _translate_weights(cls: str, arrays: Dict[str, np.ndarray],
                           lname: str, fmt: str) -> Dict[str, np.ndarray]:
        a = arrays
        if cls in ("Dense", "TimeDistributedDense", "TimeDistributed"):
            # TimeDistributed(Dense) stores plain Dense kernel/bias under
            # the wrapper layer's name
            out = {}
            k = a.get("kernel", a.get(f"{lname}_W"))
            b = a.get("bias", a.get(f"{lname}_b"))
            if k is not None:
                out["W"] = k  # keras Dense kernel is [in, out] — ours too
            if b is not None:
                out["b"] = b
            return out
        if cls in ("Convolution2D", "Conv2D"):
            k = a.get("kernel", a.get(f"{lname}_W"))
            b = a.get("bias", a.get(f"{lname}_b"))
            out = {}
            if k is not None:
                if k.ndim == 4 and fmt == "channels_first":
                    k = np.transpose(k, (2, 3, 1, 0))  # OIHW → HWIO
                out["W"] = k  # tf format already HWIO
            if b is not None:
                out["b"] = b
            return out
        if cls == "LSTM":
            return KerasModelImport._translate_lstm(a, lname)
        if cls == "Embedding":
            k = a.get("embeddings", a.get(f"{lname}_W"))
            return {} if k is None else {"W": k}
        if cls == "BatchNormalization":
            out = {}
            for src, dst in (("gamma", "gamma"), ("beta", "beta"),
                             ("moving_mean", "mean"),
                             ("moving_variance", "var")):
                v = a.get(src, a.get(f"{lname}_{src}"))
                if v is not None:
                    out[dst] = v
            return out
        return {}

    @staticmethod
    def _translate_lstm(a: Dict[str, np.ndarray], lname: str
                        ) -> Dict[str, np.ndarray]:
        """Keras LSTM → our [a|i|f|o]-concatenated layout (a = keras 'c'
        candidate). Keras 2: kernel [in, 4H] gate order i,f,c,o. Keras 1:
        separate W_i/U_i/b_i per gate."""
        def reorder(k):  # [.., 4H] i,f,c,o → a,i,f,o
            H = k.shape[-1] // 4
            i, f, c, o = (k[..., :H], k[..., H:2 * H],
                          k[..., 2 * H:3 * H], k[..., 3 * H:])
            return np.concatenate([c, i, f, o], axis=-1)

        if "kernel" in a:  # keras 2
            out = {"W": reorder(a["kernel"]),
                   "RW": reorder(a["recurrent_kernel"])}
            if "bias" in a:
                out["b"] = reorder(a["bias"])
            return out
        # keras 1: per-gate arrays
        def get(g, kind):
            return a.get(f"{lname}_{kind}_{g}", a.get(f"{kind}_{g}"))
        gates = ["c", "i", "f", "o"]
        W = np.concatenate([get(g, "W") for g in gates], axis=-1)
        RW = np.concatenate([get(g, "U") for g in gates], axis=-1)
        b = np.concatenate([get(g, "b") for g in gates], axis=-1)
        return {"W": W, "RW": RW, "b": b}
