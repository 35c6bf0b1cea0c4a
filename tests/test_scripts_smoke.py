"""Scripts tripwire: parse + main guard + SIGNATURE PINNING.

A script that calls a drifted API fails only when it runs — a TypeError
that `ast.parse` cannot see.  This test resolves every call a script makes
into an `rtm_tpu` function and validates the call's keyword/positional
arguments against the LIVE `inspect.signature`, so deleting or renaming a
public kwarg breaks the suite without running the scripts (full runs stay
manual, on hardware).  The scripts are scripts/*.py and the entry scripts
at the repository root.
"""
import ast
import importlib
import inspect
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"


def _script_files():
    return sorted(SCRIPTS.glob("*.py")) + [
        ROOT / name for name in ("bench.py", "chip_smoke.py",
                                 "__graft_entry__.py")]


def test_scripts_parse_and_have_main_guard():
    assert SCRIPTS.is_dir()
    checked = 0
    for f in _script_files():
        src = f.read_text()
        tree = ast.parse(src, filename=str(f))   # raises on syntax error
        assert "__main__" in src, f"{f.name} has no main guard"
        assert tree.body, f.name
        checked += 1
    assert checked >= 6


def _imported_rtm_symbols(tree):
    """name-in-script -> (module path, attr or None) for rtm_tpu imports."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("rtm_tpu"):
                    out[a.asname or a.name.split(".")[0]] = (a.name, None)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("rtm_tpu"):
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
    return out


def _resolve(func_node, symbols):
    """Resolve a Call's func node to a live rtm_tpu callable (or None)."""
    if isinstance(func_node, ast.Name) and func_node.id in symbols:
        mod, attr = symbols[func_node.id]
    elif (isinstance(func_node, ast.Attribute)
          and isinstance(func_node.value, ast.Name)
          and func_node.value.id in symbols):
        mod, base_attr = symbols[func_node.value.id]
        if base_attr is not None:     # attribute of an imported object
            return None
        mod, attr = mod, func_node.attr
    else:
        return None
    try:
        m = importlib.import_module(mod)
        obj = getattr(m, attr) if attr else m
    except (ImportError, AttributeError):
        return "MISSING"              # symbol drift is itself a failure
    return obj if callable(obj) else None


def test_script_calls_match_live_signatures():
    problems = []
    checked_calls = 0
    for f in _script_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        symbols = _imported_rtm_symbols(tree)
        if not symbols:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            target = _resolve(node.func, symbols)
            if target is None:
                continue
            loc = f"{f.name}:{node.lineno}"
            if target == "MISSING":
                problems.append(f"{loc}: imports a symbol that no longer "
                                "exists in rtm_tpu")
                continue
            try:
                sig = inspect.signature(target)
            except (TypeError, ValueError):
                continue
            params = sig.parameters
            has_var_kw = any(p.kind == p.VAR_KEYWORD
                             for p in params.values())
            has_var_pos = any(p.kind == p.VAR_POSITIONAL
                              for p in params.values())
            checked_calls += 1
            for kw in node.keywords:
                if kw.arg is None:                       # **expansion
                    continue
                if not has_var_kw and kw.arg not in params:
                    problems.append(
                        f"{loc}: {getattr(target, '__name__', target)}() "
                        f"has no keyword {kw.arg!r}")
            if not has_var_pos and not any(a for a in node.args
                                           if isinstance(a, ast.Starred)):
                max_pos = sum(p.kind in (p.POSITIONAL_ONLY,
                                         p.POSITIONAL_OR_KEYWORD)
                              for p in params.values())
                if len(node.args) > max_pos:
                    problems.append(
                        f"{loc}: {getattr(target, '__name__', target)}() "
                        f"takes <= {max_pos} positional args, "
                        f"call passes {len(node.args)}")
    assert not problems, "\n".join(problems)
    # the tripwire must actually cover the entry points
    assert checked_calls >= 80, checked_calls
