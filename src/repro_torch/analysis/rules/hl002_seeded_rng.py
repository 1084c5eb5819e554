"""HL002: simulation code may only use seeded generators.

Copy of the JAX package's rule, with torch's generators in place of
``jax.random``'s keys.

Every differential oracle in this repo pins the fast engine against a
naive rescan at 1e-9 on *randomized* inputs, and every trace spec
(``PoissonTrace`` …) promises bit-identical replay from its ``seed``
field.  Both guarantees die the moment simulation code touches
process-global RNG state: stdlib ``random.*``, the legacy
``np.random.*`` module functions (one hidden global ``RandomState``),
or an entropy-seeded ``default_rng()``.

Scope: ``core/``, ``runtime/``, ``workloads/`` (the deterministic
simulation layers).  Where the reference exempts ``jax.random`` (its
keys are explicit), the port exempts the explicit ``torch.Generator``: a
torch sampler (``torch.rand``, ``randn``, ``randint``, ``randperm``,
``normal``, ``bernoulli``, ``multinomial``, the ``*_like`` draws, and the
in-place ``uniform_``, ``normal_``, ``random_`` … on any tensor) passes only
with ``generator=``.  ``torch.manual_seed``, ``torch.random.manual_seed``,
``torch.cuda.manual_seed[_all]`` and any ``.seed()`` (``torch.seed``,
``torch.random.seed``, a generator's own) are flagged: the first seed
process-global state, the last draw a seed from entropy.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from ..base import (FileContext, Finding, dotted_name, from_imports,
                    import_aliases, register)

# the non-legacy surface of numpy.random: everything else on the module is
# a hidden-global-state function (NPY002 territory)
NUMPY_RANDOM_ALLOWED = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64",
})
# torch's functions that draw: each takes ``generator=``, or else draws
# from the process-global default generator
TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
# the in-place draws, tensor methods (and ``torch.nn.init``'s functions)
TORCH_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_", "trunc_normal_",
})
# modules whose seeding functions seed process-global generators
TORCH_GLOBAL_SEEDERS = frozenset({"torch", "torch.random", "torch.cuda"})
GLOBAL_SEEDS = frozenset({"manual_seed", "manual_seed_all", "seed", "seed_all"})


def torch_names(tree: ast.Module) -> Dict[str, str]:
    """Local name -> the full torch name it is bound to: ``import torch``
    (``import torch.x`` binds ``torch`` too), ``import torch.x as y``,
    ``from torch[.x] import y [as z]``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    out[a.asname or "torch"] = a.name if a.asname else "torch"
        elif isinstance(node, ast.ImportFrom) and node.module \
                and (node.module == "torch" or node.module.startswith("torch.")):
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def full_name(node: ast.AST, names: Dict[str, str]) -> Optional[str]:
    """``node``'s dotted name with its first component resolved through
    the file's torch imports (None when it is no torch name)."""
    dotted = dotted_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    if head not in names:
        return None
    return names[head] + ("." + rest if rest else "")


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register
class SeededRngRule:
    code = "HL002"
    name = "seeded-rng"
    description = ("core/runtime/workloads must use seeded "
                   "np.random.default_rng(seed) or an explicit "
                   "torch.Generator; stdlib random, legacy np.random.* "
                   "module functions and torch's global RNG are forbidden")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.is_test or not ctx.in_dir("core", "runtime", "workloads"):
            return
        tree = ctx.tree
        np_aliases = import_aliases(tree, "numpy")
        random_aliases = import_aliases(tree, "random")
        # `from numpy import random [as npr]` behaves like the module
        npr_aliases = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "numpy":
                for a in node.names:
                    if a.name == "random":
                        npr_aliases.add(a.asname or a.name)

        # from random import shuffle / from numpy.random import seed
        for local, node in from_imports(tree, "random").items():
            yield ctx.finding(
                node, self.code,
                f"stdlib random import ('{local}') draws from unseedable "
                f"process-global state; use np.random.default_rng(seed)")
        for local, node in from_imports(tree, "numpy.random").items():
            if local not in NUMPY_RANDOM_ALLOWED:
                yield ctx.finding(
                    node, self.code,
                    f"legacy np.random function import ('{local}') mutates "
                    f"the hidden global RandomState; use "
                    f"np.random.default_rng(seed)")

        default_rng_names = {local for local in
                             from_imports(tree, "numpy.random")
                             if local == "default_rng"}

        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            # random.shuffle(...) via `import random`
            if isinstance(base, ast.Name) and base.id in random_aliases:
                yield ctx.finding(
                    node, self.code,
                    f"stdlib random.{node.attr} draws from unseedable "
                    f"process-global state; use np.random.default_rng(seed)")
                continue
            # np.random.X  /  (from numpy import random).X
            is_np_random = (
                (isinstance(base, ast.Attribute) and base.attr == "random"
                 and isinstance(base.value, ast.Name)
                 and base.value.id in np_aliases)
                or (isinstance(base, ast.Name) and base.id in npr_aliases))
            if is_np_random and node.attr not in NUMPY_RANDOM_ALLOWED:
                yield ctx.finding(
                    node, self.code,
                    f"legacy np.random.{node.attr} mutates the hidden "
                    f"global RandomState; use np.random.default_rng(seed)")

        # unseeded default_rng(): entropy-seeded Generator breaks replay
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_default_rng = (
                (isinstance(func, ast.Attribute)
                 and func.attr == "default_rng")
                or (isinstance(func, ast.Name)
                    and func.id in default_rng_names))
            if is_default_rng and not node.args and not node.keywords:
                yield ctx.finding(
                    node, self.code,
                    "default_rng() with no seed draws OS entropy and breaks "
                    "deterministic replay; pass an explicit seed")

        yield from self._check_torch(ctx, random_aliases | npr_aliases
                                     | {f"{a}.random" for a in np_aliases})

    def _check_torch(self, ctx: FileContext, flagged_bases: set,
                     ) -> Iterable[Finding]:
        """torch's global RNG. ``flagged_bases``: the stdlib and numpy
        random modules, whose ``seed`` the checks above report."""
        names = torch_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "seed":
                if dotted_name(func.value) not in flagged_bases:
                    yield ctx.finding(
                        node, self.code,
                        f"{dotted_name(func) or 'seed'}() seeds from OS "
                        f"entropy and breaks deterministic replay; seed "
                        f"a torch.Generator with manual_seed(seed)")
                continue
            full = full_name(func, names)
            if full is None and isinstance(func, ast.Attribute) \
                    and func.attr in TORCH_INPLACE_SAMPLERS:
                full = func.attr                # a tensor's in-place draw
            if full is None:
                continue
            module, _, name = full.rpartition(".")
            if name in GLOBAL_SEEDS and module in TORCH_GLOBAL_SEEDERS:
                yield ctx.finding(
                    node, self.code,
                    f"{full}() seeds torch's process-global generator; "
                    f"draw from an explicit torch.Generator")
            elif ((name in TORCH_SAMPLERS and module in ("torch", "torch.random"))
                  or name in TORCH_INPLACE_SAMPLERS) \
                    and not _has_generator(node):
                yield ctx.finding(
                    node, self.code,
                    f"{full}() without generator= draws from torch's "
                    f"process-global generator; pass "
                    f"generator=torch.Generator(...).manual_seed(seed)")
