"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's stand-in for ``jax.tree``: parameters, optimizer state and
checkpoints are plain containers, and these helpers walk them in a fixed
order (dict keys as inserted, sequences by index, NamedTuples by field).
``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """Yield ``(path, leaf)``; a path is the tuple of keys, indices and field
    names from the root."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from leaves_with_paths(sub, path + (key,))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_paths(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_paths(sub, path + (i,))
    else:
        yield path, tree


def leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def key_of(path: Tuple) -> str:
    """The flat name of a path, e.g. ``params/layers/0/wq``."""
    return "/".join(str(p) for p in path)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_paths(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` applied leaf by leaf; the result has ``tree``'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)
