"""Repo-idiom AST lint: source rules over ``src/repro_torch`` (its
``benchmarks/`` included): the port of the JAX package's
``analysis/lint.py``.

Where the program rules audit what a step DID, these audit what the
source SAYS: every collective must go through ``parallel/axes.py``'s
``Group`` (the only place ``record_collectives`` can see it, and so the
only place the energy account can price it), nothing may call the
deprecated shims the deprecation tests pin, benchmark suites must
record to the shared ledger, and random draws must be seeded (an
unseeded draw breaks the measured-vs-predicted reproducibility).  A pure
``ast`` walk: no third-party linter is needed at run time.

The reference's ``raw-shard-map`` (``jax.shard_map`` outside its compat
shim) has no torch counterpart; ``raw-collective`` is the rule with the
same aim.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import ERROR, WARNING, Finding

# the deprecated config-shim surfaces (only the shim-pinning tests may
# touch them)
DEPRECATED_KEYWORDS = ("ffn_impl", "apply_ffn", "apply_attn_proj")
DEPRECATED_CALLS = ("pp_costs",)

# np.random entry points that are fine when (and only when) seeded
_SEEDED_FACTORIES = ("default_rng", "RandomState", "SeedSequence",
                     "Generator")
# torch draws that take the global generator unless given ``generator=``
_TORCH_DRAWS = ("rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "normal", "bernoulli",
                "multinomial")

# torch.distributed calls that move data between ranks; barrier and the
# process-group set-up move none
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "broadcast", "broadcast_object_list", "reduce", "gather",
                "scatter", "send", "recv", "isend", "irecv",
                "batch_isend_irecv", "P2POp")
# the files allowed to call them: the Group methods, and the mesh's
# process-group set-up
_RAW_COLLECTIVE_ALLOW = ("parallel/axes.py", "launch/mesh.py")

SOURCE_RULES: Dict[str, Tuple[str, str, str]] = {
    # id -> (severity, rationale, short title)
    "raw-collective": (
        ERROR,
        "a torch.distributed collective, send or receive called outside "
        "parallel/axes.py's Group is invisible to record_collectives, so "
        "no CommEvent prices it",
        "raw torch.distributed collective"),
    "deprecated-shim": (
        ERROR,
        "ffn_impl / PhantomConfig.apply_* / pp_costs are deprecation "
        "shims kept for external callers; in-repo code uses "
        "ProjectionMap / phantom_costs",
        "deprecated shim call"),
    "ledger-missing": (
        WARNING,
        "a benchmark suite that never records to the shared Ledger "
        "produces numbers the report join can't see",
        "suite records nothing"),
    "unseeded-prng": (
        WARNING,
        "unseeded RNGs break run-to-run reproducibility of the "
        "measured-vs-predicted ledger",
        "unseeded PRNG"),
}


def _attr_chain(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _dist_aliases(tree: ast.AST) -> set:
    """The names this file binds to ``torch.distributed``."""
    out = {"torch.distributed"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


def _lint_tree(tree: ast.AST, rel: str) -> List[Finding]:
    out: List[Finding] = []

    def add(rule: str, line: int, msg: str, key: str):
        sev = SOURCE_RULES[rule][0]
        out.append(Finding(rule, sev, rel, f"{rel}:{line}: {msg}",
                           key=key, detail={"line": line}))

    allow_raw = rel.replace(os.sep, "/").endswith(_RAW_COLLECTIVE_ALLOW)
    dist = _dist_aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and not allow_raw:
            if node.module == "torch.distributed":
                for a in node.names:
                    if a.name in _COLLECTIVES:
                        add("raw-collective", node.lineno,
                            f"imports {a.name} from torch.distributed "
                            f"instead of issuing it through "
                            f"parallel/axes.py's Group", key=a.name)
        elif isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            root, _, leaf = chain.rpartition(".")
            leaf = leaf or chain
            if not allow_raw and root in dist and leaf in _COLLECTIVES:
                add("raw-collective", node.lineno,
                    f"calls {chain} directly instead of through "
                    f"parallel/axes.py's Group", key=leaf)
            if leaf in DEPRECATED_CALLS:
                add("deprecated-shim", node.lineno,
                    f"calls deprecated {leaf}()", key=leaf)
            for kw in node.keywords:
                if kw.arg in DEPRECATED_KEYWORDS:
                    add("deprecated-shim", node.lineno,
                        f"passes deprecated keyword {kw.arg}= "
                        f"(use ModelConfig.projections)",
                        key=f"kw:{kw.arg}")
            if chain.startswith(("np.random.", "numpy.random.")):
                if leaf in _SEEDED_FACTORIES:
                    if not node.args and not node.keywords:
                        add("unseeded-prng", node.lineno,
                            f"{chain}() without a seed", key=leaf)
                elif leaf != "Generator":
                    add("unseeded-prng", node.lineno,
                        f"{chain}() uses numpy's global unseeded "
                        f"generator (use np.random.default_rng(seed))",
                        key=leaf)
            elif root == "torch" and leaf in _TORCH_DRAWS and not any(
                    kw.arg == "generator" for kw in node.keywords):
                add("unseeded-prng", node.lineno,
                    f"{chain}() draws from torch's global generator "
                    f"(pass generator=torch.Generator().manual_seed(s))",
                    key=f"torch.{leaf}")
    return out


def _is_bench_suite(rel: str) -> bool:
    norm = rel.replace(os.sep, "/")
    return "/benchmarks/" in f"/{norm}" and norm.endswith(".py") \
        and os.path.basename(norm) not in ("common.py", "run.py",
                                           "__init__.py")


def lint_file(path: str, rel: str) -> List[Finding]:
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding("deprecated-shim", ERROR, rel,
                        f"{rel}: unparseable: {e}", key="syntax")]
    out = _lint_tree(tree, rel)
    if _is_bench_suite(rel) and not any(
            tok in src for tok in ("emit(", "get_ledger", "record_to",
                                   ".record(")):
        out.append(Finding(
            "ledger-missing", WARNING, rel,
            f"{rel}: benchmark suite never records to a ledger "
            f"(benchmarks/common.py: emit)", key="ledger"))
    return out


def lint_sources(root: str, subdirs=("src/repro_torch",)) -> List[Finding]:
    """Walk the port's own source, its ``benchmarks/`` included (tests
    are out of scope: the shim-pinning tests must keep calling the
    shims)."""
    out: List[Finding] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, root)
                out.extend(lint_file(path, rel))
    return out
