"""Pipeline module: a model as a sequence of layers, split into stages
(port of ``deepspeed_tpu/runtime/pipe/module.py``: ``LayerSpec`` ``:42``,
``TiedLayerSpec`` ``:64``, ``PipelineModule`` ``:76-519``).

The parameter tree is the JAX package's, ``{"layers": (one dict per
layer, ...), "tied": {key: shared params}}``, so a tree and the
per-layer checkpoint files move between the two packages unchanged.
The JAX package traces the whole tree on every device; here each stage
is one process that holds only its own layers: :meth:`PipelineModule.init_stage`
draws the params of the given layers alone, plus the tied params they
use (``{"layers": {index: dict}, "tied": {...}}``), and every holder of
a tied param draws it from its owning layer's seed, so the copies start
equal.

Layer contract: a built layer is either

- an object with ``init(seed) -> params`` (a dict of numpy arrays or
  tensors; ``seed`` an int) and ``apply(params, x, **kw) -> y``,
- or a plain callable ``f(x) -> y`` (parameter-less).

``apply`` gets only the keyword arguments its signature takes, of
``rng`` (a ``torch.Generator`` on the activations' device, shared by the
layers of one stage and drawn in layer order), ``deterministic`` and,
above one ``seq`` rank, ``attn_seed_rng`` (the stage's stream before the
seq mixing, from which the port's dense attention core draws its
in-kernel dropout's seed words).  The final ``loss_fn(outputs, labels)``
maps the last layer's output and the batch labels to a scalar loss.

Above one ``seq`` rank each stage runs its layers on the rank's chunk
of the sequence (dim 1), so every layer must declare it is right there:
a class attribute ``seq_parallel = True`` (or the attribute on a plain
callable, or on a tied use's ``forward_fn``), meaning its output at a
position depends on its input at that position alone, or that it mixes
positions only through the port's attention cores over ``seq``, as
:class:`~deepspeed_tpu_torch.models.layers.TransformerLayer` does.  A
layer that reads positions (a position table) must take its chunk's
global ones (:func:`~deepspeed_tpu_torch.models.layers.seq_offset`)
before it declares so.  The engine refuses a module with a layer that
does not (:meth:`PipelineModule.seq_unready`).

Layer seeds: with ``seed_layers`` layer ``i`` draws from ``base_seed +
i`` (through ``seed_fn``), else from stream ``i`` of the engine's seed
(:func:`~deepspeed_tpu_torch.models.layers.mix_seed`), so a layer's
weights do not depend on the partition.  Tensor parallelism: a layer
may declare ``partition_specs()``, the port's slicing of its params over
``model`` and ``expert`` (a tree like its ``init`` params, as
:meth:`~deepspeed_tpu_torch.models.layers.TransformerLayer.partition_specs`);
:meth:`PipelineModule.partition_specs` gathers them into the tree's
specs (undeclared layers replicated, a tied key taking its owner's spec
of the shared entry), and the engine slices each stage's tree by them.
"""

import inspect
import logging
import os
import re

import numpy as np
import torch

from ...models.layers import mix_seed, recomputed
from ...utils.params import tree_leaves
from ..utils import partition_balanced, partition_uniform, tree_path_key

logger = logging.getLogger(__name__)


class LayerSpec:
    """Delayed-construction layer description:
    ``typename(*module_args, **module_kwargs)`` builds the layer."""

    def __init__(self, typename, *module_args, **module_kwargs):
        if not isinstance(typename, type):
            raise RuntimeError("LayerSpec only supports classes")
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, log=False):
        if log:
            logger.info(f"building {self!r}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return f"LayerSpec({self.typename.__name__})"


class TiedLayerSpec(LayerSpec):
    """A layer whose params (or, with ``tied_weight_attr`` in a dict of
    several, that one entry) are shared by key across its uses, e.g. the
    input embedding and the LM head; ``forward_fn(params, x)`` replaces
    the layer's ``apply`` at this use."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


class PipelineModule:
    """Sequence-of-layers model for pipeline execution.

    Args:
        layers: iterable of LayerSpec / TiedLayerSpec / layer objects /
            callables.
        num_stages: pipeline depth (defaults to the mesh's ``pipe`` axis).
        loss_fn: ``loss_fn(outputs, labels) -> scalar``.
        partition_method: 'uniform' | 'parameters' | 'type:regex'.
        activation_checkpoint_interval: recompute every N layers in
            backward (:meth:`apply_range`).
        interleave: virtual stages per rank: the layers split into
            ``stages × interleave`` logical stages, logical stage ``l``
            on rank ``l % stages`` (JAX ``engine.py:83-87``).
    """

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seed_layers=False, seed_fn=None,
                 base_seed=1234, partition_method="parameters",
                 activation_checkpoint_interval=0,
                 activation_checkpoint_func=None, interleave=1):
        self.layer_specs = []
        for layer in layers:
            if isinstance(layer, type):
                layer = LayerSpec(layer)
            self.layer_specs.append(layer)
        self.num_stages = num_stages
        self.topology = topology
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.seed_fn = seed_fn
        self.base_seed = base_seed
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.activation_checkpoint_func = activation_checkpoint_func
        self.interleave = max(int(interleave or 1), 1)
        self._parts = None
        self._built = {}
        self._sig_cache = {}
        self.tied_keys = {}      # key -> index of the owning (first) layer
        self._tied_key_of = {}   # layer index -> key
        self._tied_attr_of = {}  # layer index -> tied_weight_attr
        self._forward_fns = {}   # layer index -> forward_fn
        self._tied_subset_mode = {}
        for idx, spec in enumerate(self.layer_specs):
            if not isinstance(spec, TiedLayerSpec):
                continue
            if spec.key not in self.tied_keys:
                self.tied_keys[spec.key] = idx
            else:
                owner_attr = self._tied_attr_of[self.tied_keys[spec.key]]
                if spec.tied_weight_attr != owner_attr:
                    raise ValueError(
                        f"tied key {spec.key!r}: tied_weight_attr "
                        f"{spec.tied_weight_attr!r} != owner's "
                        f"{owner_attr!r}")
            self._tied_key_of[idx] = spec.key
            self._tied_attr_of[idx] = spec.tied_weight_attr
            if spec.forward_fn is not None:
                self._forward_fns[idx] = spec.forward_fn

    # ------------------------------------------------------------ layers
    @property
    def num_layers(self):
        return len(self.layer_specs)

    def layer(self, idx):
        """Layer ``idx``, built from its spec on first use (a stage
        builds only the layers it runs)."""
        if idx not in self._built:
            spec = self.layer_specs[idx]
            self._built[idx] = (spec.build() if isinstance(spec, LayerSpec)
                                else spec)
        return self._built[idx]

    @property
    def layers(self):
        return [self.layer(i) for i in range(self.num_layers)]

    def seq_unready(self):
        """``"index: name"`` of each layer that does not declare
        ``seq_parallel`` (at a tied use with a ``forward_fn``, the
        function must)."""
        out = []
        for idx, spec in enumerate(self.layer_specs):
            target = self._forward_fns.get(idx)
            if target is None:
                target = (spec.typename if isinstance(spec, LayerSpec)
                          else spec)
            if not getattr(target, "seq_parallel", False):
                name = getattr(target, "__name__", type(target).__name__)
                out.append(f"{idx}: {name}")
        return out

    def has_params(self, idx):
        layer = self.layer(idx)
        return hasattr(layer, "init") and hasattr(layer, "apply")

    def tied_key_of(self, idx):
        """The tied key of layer ``idx``, or None."""
        return self._tied_key_of.get(idx)

    def tied_keys_of(self, indices):
        """The tied keys the layers ``indices`` use, in key order."""
        return sorted({self._tied_key_of[i] for i in indices
                       if i in self._tied_key_of})

    # -------------------------------------------------------- parameters
    def layer_seed(self, seed, idx):
        """Layer ``idx``'s init seed."""
        if self.seed_layers:
            s = self.base_seed + idx
            return int(self.seed_fn(s)) if self.seed_fn is not None else s
        return mix_seed(seed, idx)

    def _init_layer(self, seed, idx):
        """``(slot, shared)``: layer ``idx``'s own params and, for the
        owner of a tied key, the shared params (JAX ``module.py:157-257``:
        with ``tied_weight_attr`` in a dict of several entries only that
        entry is shared and every use keeps the rest; else the owner's
        whole tree is shared and other uses keep nothing)."""
        if not self.has_params(idx):
            return {}, None
        tkey = self._tied_key_of.get(idx)
        attr = self._tied_attr_of.get(idx)
        if tkey is None:
            return self.layer(idx).init(self.layer_seed(seed, idx)), None
        owner = self.tied_keys[tkey]
        if owner == idx:
            p = self.layer(idx).init(self.layer_seed(seed, idx))
            subset = isinstance(p, dict) and attr in p and len(p) > 1
            self._tied_subset_mode[tkey] = subset
            if subset:
                return {k: v for k, v in p.items() if k != attr}, p[attr]
            return {}, p
        if tkey not in self._tied_subset_mode:
            self._init_layer(seed, owner)
        if not self._tied_subset_mode[tkey]:
            return {}, None
        p = self.layer(idx).init(self.layer_seed(seed, idx))
        if not (isinstance(p, dict) and attr in p):
            raise ValueError(
                f"tied key {tkey!r} (subset mode, attr {attr!r}): use-site "
                f"layer {idx} init() must return a dict containing {attr!r}")
        return {k: v for k, v in p.items() if k != attr}, None

    def init(self, seed):
        """The whole param tree ``{"layers": (...), "tied": {...}}``."""
        stage = self.init_stage(seed, range(self.num_layers))
        return {"layers": tuple(stage["layers"][i]
                                for i in range(self.num_layers)),
                "tied": stage["tied"]}

    def init_stage(self, seed, indices):
        """The params of the layers ``indices`` alone, ``{"layers":
        {index: dict}, "tied": {key: ...}}`` with every tied key those
        layers use: drawn layer by layer, the tied params from their
        owner's seed whether or not the owner is among ``indices``."""
        owners = {}   # each tied key's owner drawn once
        for key in self.tied_keys_of(indices):
            owners[self.tied_keys[key]] = self._init_layer(
                seed, self.tied_keys[key])
        layers = {idx: (owners[idx][0] if idx in owners
                        else self._init_layer(seed, idx)[0])
                  for idx in sorted(indices)}
        tied = {self._tied_key_of[idx]: shared
                for idx, (_, shared) in owners.items()}
        return {"layers": layers, "tied": dict(sorted(tied.items()))}

    def select_stage(self, params, indices):
        """The stage tree of ``indices`` cut from a whole tree (its leaves
        shared, not copied)."""
        return {"layers": {i: params["layers"][i] for i in sorted(indices)},
                "tied": {k: params["tied"][k]
                         for k in self.tied_keys_of(indices)}}

    def _layer_specs(self, idx):
        """``(slot spec, shared spec)`` of layer ``idx`` split as
        :meth:`_init_layer` splits its params (None: replicated)."""
        decl = getattr(self.layer(idx), "partition_specs", None)
        if decl is None or not self.has_params(idx):
            return None, None
        spec = decl()
        tkey = self._tied_key_of.get(idx)
        if tkey is None:
            return spec, None
        attr = self._tied_attr_of[idx]
        if isinstance(spec, dict) and attr in spec and len(spec) > 1:
            return ({k: v for k, v in spec.items() if k != attr},
                    spec[attr] if self.tied_keys[tkey] == idx else None)
        return None, spec if self.tied_keys[tkey] == idx else None

    def partition_specs(self, mesh=None):
        """The whole tree's specs, ``{"layers": (...), "tied": {...}}``
        (JAX ``module.py:248-330``): each layer's declared
        ``partition_specs()``, undeclared layers replicated, a tied key
        its owning layer's spec of the shared params."""
        return self.stage_specs(range(self.num_layers), whole=True)

    def stage_specs(self, indices, whole=False):
        """The specs of :meth:`init_stage`'s tree of the layers
        ``indices`` (``whole``: of :meth:`init`'s tree)."""
        layers = {i: self._layer_specs(i)[0] for i in sorted(indices)}
        tied = {k: self._layer_specs(self.tied_keys[k])[1]
                for k in self.tied_keys_of(indices)}
        if whole:
            layers = tuple(layers[i] for i in range(self.num_layers))
        return {"layers": layers, "tied": tied}

    def layer_param_counts(self, params=None, seed=0):
        """Per-layer parameter counts for 'parameters' partitioning (JAX
        ``module.py:318-331``); a tied key counts at its owning layer.
        Without ``params`` each layer is drawn alone and counted, so
        the whole model is never held at once."""
        counts = []
        for idx in range(self.num_layers):
            if params is not None:
                slot = params["layers"][idx]
                tkey = self._tied_key_of.get(idx)
                shared = (params["tied"][tkey]
                          if tkey is not None and self.tied_keys[tkey] == idx
                          else None)
            else:
                slot, shared = self._init_layer(seed, idx)
            leaves = tree_leaves(slot)[1] if slot else []
            if shared is not None:
                leaves += tree_leaves(shared)[1]
            counts.append(int(sum(np.prod(np.shape(x)) for x in leaves)))
        return counts

    def _layer_params(self, params, idx):
        tkey = self._tied_key_of.get(idx)
        slot = params["layers"][idx]
        if tkey is None:
            return slot
        if isinstance(slot, dict) and slot:
            # subset tying: this use's own params + the shared entry
            return {**slot, self._tied_attr_of[idx]: params["tied"][tkey]}
        return params["tied"][tkey]

    # ----------------------------------------------------------- forward
    def _accepted_kwargs(self, idx, kw):
        """``kw`` cut to what layer ``idx``'s apply takes."""
        if not kw:
            return kw
        if idx not in self._sig_cache:
            fn = (self._forward_fns.get(idx)
                  or (self.layer(idx).apply if self.has_params(idx)
                      else self.layer(idx)))
            try:
                sig = inspect.signature(fn)
                if any(p.kind == inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values()):
                    self._sig_cache[idx] = None
                else:
                    self._sig_cache[idx] = set(sig.parameters)
            except (TypeError, ValueError):
                self._sig_cache[idx] = set()
        allowed = self._sig_cache[idx]
        if allowed is None:
            return kw
        return {k: v for k, v in kw.items() if k in allowed}

    def apply_layer(self, params, idx, x, **kw):
        kw = self._accepted_kwargs(idx, kw)
        if idx in self._forward_fns:
            return self._forward_fns[idx](self._layer_params(params, idx),
                                          x, **kw)
        if self.has_params(idx):
            return self.layer(idx).apply(self._layer_params(params, idx),
                                         x, **kw)
        return self.layer(idx)(x, **kw)

    def apply_range(self, params, start, stop, x, interval=None, **kw):
        """Layers ``[start, stop)``; with ``activation_checkpoint_interval``
        (or ``interval``) > 0 each run of that many layers is recomputed
        in backward instead of keeping its activations (:func:`recomputed`,
        which replays the ``rng`` and ``attn_seed_rng`` generators, so the
        recompute draws the forward's dropout masks)."""
        interval = (self.activation_checkpoint_interval if interval is None
                    else interval)
        if interval <= 0:
            for idx in range(start, stop):
                x = self.apply_layer(params, idx, x, **kw)
            return x

        def chunk(lo, hi):
            def run(x):
                for idx in range(lo, hi):
                    x = self.apply_layer(params, idx, x, **kw)
                return x
            return run

        gens = [g for g in (kw.get("rng"), kw.get("attn_seed_rng"))
                if isinstance(g, torch.Generator)]
        for lo in range(start, stop, interval):
            x = recomputed(chunk(lo, min(lo + interval, stop)), *gens)(x)
        return x

    def sequential_apply(self, params, batch, rng=None, train=False, **kw):
        """Every layer in order, then the loss (the outputs without
        labels or ``loss_fn``).  ``rng`` is an int seed (or a
        ``torch.Generator``): the layers draw dropout from one generator
        on the inputs' device seeded with it."""
        inputs, labels = split_batch(batch)
        layer_kw = dict(kw)
        if rng is not None:
            layer_kw["rng"] = stage_generator(rng, inputs)
        layer_kw["deterministic"] = not train
        x = self.apply_range(params, 0, self.num_layers, inputs, **layer_kw)
        if self.loss_fn is not None and labels is not None:
            return self.loss_fn(x, labels)
        return x

    # ------------------------------------------------------ partitioning
    def partition_layers(self, num_stages, param_counts=None, method=None):
        """Stage boundaries, ``len(parts) == num_stages + 1`` (JAX
        ``module.py:430-459``)."""
        method = (method or self.partition_method).lower()
        n = len(self.layer_specs)
        if method == "uniform":
            parts = partition_uniform(num_items=n, num_parts=num_stages)
        elif method == "parameters":
            if param_counts is None:
                raise ValueError("parameters method needs param counts")
            parts = partition_balanced(weights=param_counts,
                                       num_parts=num_stages)
        elif method.startswith("type:"):
            regex = method.split(":", 1)[1]
            weights = [1 if _spec_matches(s, regex) else 0
                       for s in self.layer_specs]
            parts = partition_balanced(weights=weights, num_parts=num_stages)
        elif method == "profile":
            raise NotImplementedError(
                "Partitioning by profiling is not implemented.")
        else:
            raise NotImplementedError(
                f"Partitioning method {method} not implemented.")
        self._parts = parts
        for stage in range(num_stages):
            logger.info(f"stage={stage} layers="
                        f"{parts[stage + 1] - parts[stage]} "
                        f"[{parts[stage]}, {parts[stage + 1]})")
        return parts

    # ------------------------------------------- per-layer checkpointing
    @staticmethod
    def ckpt_layer_path(ckpt_dir, local_layer_idx):
        """``layer_NN-model_states.npz`` (JAX ``module.py:468-473``)."""
        return os.path.join(ckpt_dir,
                            f"layer_{local_layer_idx:02d}-model_states.npz")

    @staticmethod
    def ckpt_tied_path(ckpt_dir, key):
        return os.path.join(ckpt_dir, f"tied_{key}-model_states.npz")

    def save_state_dict(self, params, save_dir):
        """One file per layer with params and one per tied key, keyed by
        tree path inside the layer (``_`` for a bare leaf), so another
        partition (or the JAX package) loads them.  Takes a whole tree or
        a stage tree (then it writes that stage's files); bf16 leaves are
        written as fp32, which holds them exactly."""
        os.makedirs(save_dir, exist_ok=True)
        for idx, slot in _layer_items(params):
            if not tree_leaves(slot)[1]:
                continue
            np.savez(self.ckpt_layer_path(save_dir, idx), **_host_dict(slot))
        for key, tp in params["tied"].items():
            np.savez(self.ckpt_tied_path(save_dir, key), **_host_dict(tp))

    def load_state_dir(self, params, load_dir):
        """The files of :meth:`save_state_dict` into a tree shaped like
        ``params`` (whole or stage), each leaf in its dtype and device."""
        layers = {}
        for idx, slot in _layer_items(params):
            if not tree_leaves(slot)[1]:
                layers[idx] = slot
                continue
            with np.load(self.ckpt_layer_path(load_dir, idx)) as npz:
                layers[idx] = _from_host_dict(slot, npz)
        tied = {}
        for key, tp in params["tied"].items():
            with np.load(self.ckpt_tied_path(load_dir, key)) as npz:
                tied[key] = _from_host_dict(tp, npz)
        if isinstance(params["layers"], (tuple, list)):
            layers = tuple(layers[i] for i in range(len(params["layers"])))
        return {"layers": layers, "tied": tied}


def split_batch(batch):
    """Batch convention: an ``(inputs, labels)`` pair, a dict with
    ``inputs``/``labels`` keys, or bare inputs (labels None)."""
    if isinstance(batch, (tuple, list)) and len(batch) == 2:
        return batch[0], batch[1]
    if isinstance(batch, dict) and "inputs" in batch:
        return batch["inputs"], batch.get("labels")
    return batch, None


def first_tensor(x):
    """The first tensor of an activation (a tensor or a tuple/dict)."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x
    for item in items:
        t = first_tensor(item)
        if t is not None:
            return t
    return None


def stage_generator(seed, x):
    """A ``torch.Generator`` on ``x``'s device seeded with ``seed`` (a
    generator passes through)."""
    if isinstance(seed, torch.Generator):
        return seed
    t = first_tensor(x)
    device = t.device if t is not None else torch.device("cpu")
    return torch.Generator(device=device).manual_seed(int(seed))


def _layer_items(params):
    layers = params["layers"]
    if isinstance(layers, dict):
        return sorted(layers.items())
    return list(enumerate(layers))


def _spec_matches(spec, regex):
    name = (spec.typename.__name__ if isinstance(spec, LayerSpec)
            else type(spec).__name__)
    return re.search(regex, name, re.IGNORECASE) is not None


def _host_dict(tree):
    out = {}
    paths, leaves = tree_leaves(tree)
    for path, leaf in zip(paths, leaves):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            leaf = (leaf.float() if leaf.dtype == torch.bfloat16
                    else leaf).numpy()
        out[tree_path_key(path) or "_"] = np.asarray(leaf)
    return out


def _from_host_dict(template, npz):
    def leaf_of(path, leaf):
        arr = np.asarray(npz[tree_path_key(path) or "_"])
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr.astype(np.asarray(leaf).dtype)

    paths, leaves = tree_leaves(template)
    if paths == [()]:
        return leaf_of((), leaves[0])
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf_of(path, leaf)
    return out
