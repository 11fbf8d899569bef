"""graftlint engine: parsing, directives, check registry, baseline, output.

Design notes:

- One :class:`Module` per source file: the ast tree, the raw lines, and every
  ``# graftlint:`` directive found by a ``tokenize`` pass (comments are not in
  the AST). Checks receive the Module plus a repo-level :class:`Context` and
  return :class:`Finding` lists; the engine applies suppressions and the
  baseline afterwards so checks stay oblivious to both.
- Finding fingerprints are line-number-free — ``check|path|scope|message`` —
  so a committed baseline survives unrelated edits above a grandfathered
  finding. ``scope`` is the enclosing def/class qualname.
- GL000 is the analyzer's own meta-check (malformed directives, reasonless
  suppressions, unparseable files). GL000 findings cannot be suppressed —
  otherwise a typo'd suppression could silence the report about itself.
"""

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import time
import tokenize
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from autodist_tpu_torch.analysis import callgraph

META_CHECK = "GL000"
_CHECK_ID_RE = re.compile(r"^GL\d{3}$")
_FLAG_NAME_RE = re.compile(r"^AUTODIST_[A-Z0-9_]+$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``scope`` + ``message`` (not line) key the baseline."""

    check: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str
    scope: str = ""    # enclosing def/class qualname ("" = module level)

    @property
    def fingerprint(self) -> str:
        return f"{self.check}|{self.path}|{self.scope}|{self.message}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{where}: {self.check} {self.message}{scope}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]            # new findings (post-suppress, post-baseline)
    suppressed: List[Tuple[Finding, str]]   # (finding, reason)
    baselined: List[Finding]
    stale_baseline: List[str]          # fingerprints no longer produced
    files_checked: int = 0
    wall_time_s: float = 0.0
    cache_info: Optional[Dict[str, object]] = None

    @property
    def ok(self) -> bool:
        return not self.findings


class Check:
    """Registry entry: id, one-line title, the check fn, and --explain docs.

    ``program=True`` checks run once over the whole linted file set with
    ``fn(program, ctx)`` (``program`` is a
    :class:`~autodist_tpu_torch.analysis.program.ProgramIndex`) instead of
    per-module; their results are never file-cached (a finding in one file
    can depend on another file's content). ``full_program=True`` marks the
    subset that is only sound over the COMPLETE default path set (registry
    checks like GL009: a producer missing from a partial file set is not a
    missing producer) — ``--changed-only`` skips those.
    """

    def __init__(self, check_id: str, title: str, fn: Callable, doc: str,
                 program: bool = False, full_program: bool = False):
        self.id = check_id
        self.title = title
        self.fn = fn
        self.doc = doc or ""
        self.program = program
        self.full_program = full_program


_CHECKS: Dict[str, Check] = {}


def register(check_id: str, title: str, program: bool = False,
             full_program: bool = False):
    """Decorator registering ``fn(module, ctx) -> [Finding]`` (or, with
    ``program=True``, ``fn(program, ctx)``) under ``GLxxx``."""
    if not _CHECK_ID_RE.match(check_id):
        raise ValueError(f"check id must match GLnnn, got {check_id!r}")

    def deco(fn):
        if check_id in _CHECKS:
            raise ValueError(f"duplicate check id {check_id}")
        _CHECKS[check_id] = Check(check_id, title, fn, fn.__doc__,
                                  program=program, full_program=full_program)
        return fn

    return deco


def register_program(check_id: str, title: str, full_program: bool = False):
    """Decorator registering a whole-program check
    ``fn(program, ctx) -> [Finding]`` under ``GLxxx`` (see :class:`Check`)."""
    return register(check_id, title, program=True,
                    full_program=full_program)


def all_checks() -> Dict[str, Check]:
    """The registry, with the built-in check modules imported."""
    from autodist_tpu_torch.analysis import checks  # noqa: F401  (side effect: registration)
    return dict(_CHECKS)


# ------------------------------------------------------------------ directives

_DIRECTIVE_RE = re.compile(r"#\s*graftlint\s*:\s*(.+?)\s*$")
_DISABLE_ENTRY_RE = re.compile(r"(GL\d{3})\s*(\(([^()]*)\))?")
_LOCK_ORDER_RE = re.compile(
    r"lock-order\s*=\s*([A-Za-z_][\w]*)\s*->\s*([A-Za-z_][\w]*)")


class Module:
    """One parsed source file plus its graftlint directives."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[Finding] = None
        # line -> {check_id: reason}
        self.suppressions: Dict[int, Dict[str, str]] = {}
        self.lock_orders: List[Tuple[str, str]] = []
        self.directive_findings: List[Finding] = []
        self._scopes: Optional[List[Tuple[int, int, str]]] = None
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:
            self.parse_error = Finding(
                META_CHECK, self.relpath, e.lineno or 1, e.offset or 0,
                f"file does not parse: {e.msg}")
        self._scan_directives()

    # -- directives ---------------------------------------------------------
    def _scan_directives(self):
        if "graftlint" not in self.source:
            return   # no directive can be present: skip the tokenize pass
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except (tokenize.TokenError, SyntaxError, IndentationError):
            return  # the parse_error finding already covers it
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _DIRECTIVE_RE.search(tok.string)
            if m is None:
                continue
            line = tok.start[0]
            standalone = not self.lines[line - 1][:tok.start[1]].strip()
            target = self._next_code_line(line + 1) if standalone else line
            self._parse_directive(m.group(1), line, target)

    def _next_code_line(self, start: int) -> int:
        for i in range(start, len(self.lines) + 1):
            text = self.lines[i - 1].strip()
            if text and not text.startswith("#"):
                return i
        return start

    def _parse_directive(self, body: str, line: int, target: int):
        recognized = False
        if "disable" in body:
            recognized = True
            # Everything after "disable=" is the entry list.
            _, _, entries = body.partition("disable")
            entries = entries.lstrip("= ")
            matched_any = False
            for m in _DISABLE_ENTRY_RE.finditer(entries):
                matched_any = True
                check_id, reason = m.group(1), (m.group(3) or "").strip()
                if not reason:
                    self.directive_findings.append(Finding(
                        META_CHECK, self.relpath, line, 0,
                        f"suppression of {check_id} has no reason; write "
                        f"`# graftlint: disable={check_id}(why it is safe)`"))
                    continue
                if check_id == META_CHECK:
                    self.directive_findings.append(Finding(
                        META_CHECK, self.relpath, line, 0,
                        "GL000 (analyzer meta findings) cannot be suppressed"))
                    continue
                self.suppressions.setdefault(target, {})[check_id] = reason
            if not matched_any:
                self.directive_findings.append(Finding(
                    META_CHECK, self.relpath, line, 0,
                    f"malformed disable directive {body!r}; expected "
                    f"`disable=GLnnn(reason)`"))
        for m in _LOCK_ORDER_RE.finditer(body):
            recognized = True
            self.lock_orders.append((m.group(1), m.group(2)))
        if not recognized:
            self.directive_findings.append(Finding(
                META_CHECK, self.relpath, line, 0,
                f"unrecognized graftlint directive {body!r} (known: "
                f"disable=GLnnn(reason), lock-order=a->b)"))

    def suppression_for(self, finding: Finding) -> Optional[str]:
        """The reason suppressing ``finding``, or None. A directive applies to
        its own line (trailing comment) or, standalone, to the next code line."""
        if finding.check == META_CHECK:
            return None
        by_line = self.suppressions.get(finding.line)
        if by_line and finding.check in by_line:
            return by_line[finding.check]
        return None

    # -- scopes -------------------------------------------------------------
    def scope_at(self, node_or_line) -> str:
        """Innermost enclosing def/class qualname for a node or line number."""
        line = getattr(node_or_line, "lineno", node_or_line)
        if self._scopes is None:
            self._scopes = []
            if self.tree is not None:
                self._collect_scopes(self.tree, "")
        best = ""
        best_span = None
        for start, end, name in self._scopes:
            if start <= line <= end:
                span = end - start
                if best_span is None or span <= best_span:
                    best, best_span = name, span
        return best

    def _collect_scopes(self, node, prefix: str):
        for child in callgraph.children(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                self._scopes.append(
                    (child.lineno, child.end_lineno or child.lineno, qual))
                self._collect_scopes(child, qual)
            else:
                self._collect_scopes(child, prefix)


# Repo-level files checks read OUTSIDE the linted set, hashed into the
# cache keys so an edit to any of them invalidates cached results.
# MODULE inputs (read by per-file checks: GL007's flag registry, GL008's
# markers) key BOTH layers; PROGRAM inputs (read only by program checks,
# whose results are never file-cached) key only the whole-program layer —
# a docs-only observability.md edit must not re-lint 188 files' module
# checks. Context.doc_text REFUSES paths not listed here — a future check
# cannot read a repo input the cache key does not cover (the stale-cache
# bug class, closed structurally).
# The linted package: its relpath prefix scopes the package-only rules
# (GL005, GL007, GL009, GL010, GL012) and names the flag registry.
PACKAGE = "autodist_tpu_torch"
PACKAGE_PREFIX = PACKAGE + "/"
CONST_PATH = PACKAGE_PREFIX + "const.py"
# The port's tests: ``tests/test_torch_*.py`` (GL008's naming).
TEST_PREFIX = "tests/test_torch_"
CACHE_MODULE_INPUTS = (CONST_PATH, "pyproject.toml")
CACHE_PROGRAM_INPUTS = ("docs/usage/observability.md",)
CACHE_EXTRA_INPUTS = CACHE_MODULE_INPUTS + CACHE_PROGRAM_INPUTS


class Context:
    """Repo-level facts shared across modules (const.py flag registry,
    pyproject markers). Lazily computed, overridable for fixture tests."""

    def __init__(self, root: str, known_flags: Optional[Set[str]] = None):
        self.root = root
        self._known_flags = known_flags
        self._pyproject_markers: Optional[Set[str]] = None
        # Set by lint_paths when program checks run (Phase 2 — AFTER the
        # module-check loop, so module checks must NOT read it: besides
        # always seeing None, a module check whose findings depended on
        # other files would poison the per-file cache layer).
        self.program = None
        self._doc_text: Dict[str, Optional[str]] = {}

    def doc_text(self, relpath: str) -> Optional[str]:
        """The text of a repo doc file (``docs/usage/observability.md``) or
        None when absent — fixture trees get the checks that need it
        silently skipped rather than everything flagged. Only paths in
        :data:`CACHE_EXTRA_INPUTS` may be read: anything else would be an
        input the result cache's keys do not hash."""
        if relpath not in CACHE_EXTRA_INPUTS:
            raise ValueError(
                f"check reads repo input {relpath!r} outside "
                f"CACHE_EXTRA_INPUTS; add it there so cache keys cover it")
        if relpath not in self._doc_text:
            path = os.path.join(self.root, *relpath.split("/"))
            text: Optional[str] = None
            if os.path.isfile(path):
                try:
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    text = None
            self._doc_text[relpath] = text
        return self._doc_text[relpath]

    def known_flags(self) -> Optional[Set[str]]:
        """AUTODIST_* names the package's const.py declares, the three ways
        the port's registry declares one: a key of ``_ENV_DEFAULTS`` (or a
        ``KNOWN_FLAGS`` dict), a module-level name constant
        (``AUTODIST_PS_ADDR = "AUTODIST_PS_ADDR"``, read through
        ``const.env_int`` and friends), or the literal const.py itself reads
        from the environment (``os.environ.get("AUTODIST_WORKING_DIR", ...)``).
        None when const.py is absent (fixture trees), which disables the
        unknown-flag rule rather than flagging everything."""
        if self._known_flags is not None:
            return self._known_flags
        const_path = os.path.join(self.root, *CONST_PATH.split("/"))
        if not os.path.isfile(const_path):
            return None
        flags: Set[str] = set()
        try:
            with open(const_path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            return None

        def is_flag(node) -> bool:
            return isinstance(node, ast.Constant) \
                and isinstance(node.value, str) \
                and _FLAG_NAME_RE.match(node.value) is not None

        for node in tree.body:
            if isinstance(node, ast.Assign) and is_flag(node.value) \
                    and all(isinstance(t, ast.Name) for t in node.targets):
                flags.add(node.value.value)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name) \
                            and target.id in ("KNOWN_FLAGS", "_ENV_DEFAULTS") \
                            and isinstance(node.value, ast.Dict):
                        flags.update(k.value for k in node.value.keys
                                     if is_flag(k))
            elif isinstance(node, ast.Call) and node.args \
                    and is_flag(node.args[0]):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", "")
                if name in ("get", "getenv", "setdefault"):
                    flags.add(node.args[0].value)
        self._known_flags = flags or None
        return self._known_flags

    def pyproject_markers(self) -> Set[str]:
        """Marker names registered under [tool.pytest.ini_options] markers."""
        if self._pyproject_markers is not None:
            return self._pyproject_markers
        markers: Set[str] = set()
        path = os.path.join(self.root, "pyproject.toml")
        if os.path.isfile(path):
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                text = ""
            # A full TOML parse is overkill for one list of "name: help" strings.
            for m in re.finditer(r'"([A-Za-z_][\w]*)\s*:', text):
                markers.add(m.group(1))
        self._pyproject_markers = markers
        return markers


# -------------------------------------------------------------------- baseline

def load_baseline(path: str) -> Set[str]:
    """Fingerprints grandfathered by the committed baseline file."""
    if not path or not os.path.isfile(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {e["fingerprint"] for e in data.get("findings", [])}


def write_baseline(path: str, findings: Sequence[Finding]):
    """Rewrite the baseline from the current findings (sorted, stable diffs).
    GL000 meta-findings (malformed directives etc.) are never written: they
    must be fixed, not grandfathered — the baseline matcher ignores them
    anyway (see :func:`lint_paths`)."""
    entries = sorted(
        ({"fingerprint": f.fingerprint, "note": f.render()}
         for f in findings if f.check != META_CHECK),
        key=lambda e: e["fingerprint"])
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"comment": "graftlint grandfathered findings; new findings "
                              "fail CI, these do not. Regenerate with "
                              "python -m autodist_tpu_torch.tools.graftlint "
                              "--write-baseline.",
                   "findings": entries}, f, indent=1)
        f.write("\n")


# ------------------------------------------------------------------ file walks

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules", "native"}


def iter_py_files(paths: Sequence[str], root: str):
    """Yield .py files under ``paths`` (files taken verbatim, dirs walked).
    A nonexistent path raises: a CI gate that silently lints 0 files on a
    typo'd/renamed path would green-light everything it exists to block."""
    seen = set()
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(full):
            raise FileNotFoundError(f"graftlint: path does not exist: {p}")
        if os.path.isfile(full):
            if full not in seen:
                seen.add(full)
                yield full
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    f = os.path.join(dirpath, name)
                    if f not in seen:
                        seen.add(f)
                        yield f


# ----------------------------------------------------------------------- cache

_VERSION_CACHE: Optional[str] = None


def checks_version() -> str:
    """Content hash of the analysis package's own sources — the cache key
    component that invalidates every cached result the moment a check (or
    the engine) changes, so a stale cache can never mask a new rule."""
    global _VERSION_CACHE
    if _VERSION_CACHE is None:
        h = hashlib.sha1()
        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    h.update(name.encode())
                    with open(os.path.join(dirpath, name), "rb") as f:
                        h.update(f.read())
        _VERSION_CACHE = h.hexdigest()
    return _VERSION_CACHE


def _finding_from_json(d: dict) -> Finding:
    return Finding(check=d["check"], path=d["path"], line=d["line"],
                   col=d["col"], message=d["message"],
                   scope=d.get("scope", ""))


class LintCache:
    """On-disk result cache under ``.graftlint_cache/``.

    Two layers, both keyed on content hashes plus :func:`checks_version`
    (cached RAW findings are pre-baseline, so editing the baseline never
    needs an invalidation):

    - **per-file**: (file sha1, module-check-id set) -> that file's
      module-check findings + suppressions. Program checks are excluded by
      construction — their findings can depend on *other* files.
    - **whole-program**: sha1 over every linted (relpath, sha1) pair, the
      full check selection, and the repo-level inputs the program checks
      read (const.py, pyproject.toml, observability.md) -> the complete raw
      result. An unchanged tree re-lints in file-hash time — the warm path
      ci.sh asserts.
    """

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self.path = os.path.join(dir_path, "cache.json")
        self.hits = 0
        self.misses = 0
        self.program_hit = False
        self._dirty = False
        self._data: Dict[str, dict] = {"version": checks_version(),
                                       "files": {}, "program": {}}
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict) \
                    and data.get("version") == checks_version():
                self._data = data
                self._data.setdefault("files", {})
                self._data.setdefault("program", {})
        except (OSError, ValueError):
            pass

    @staticmethod
    def file_key(sha1: str, check_ids: Sequence[str],
                 extras_sha: str = "") -> str:
        # extras_sha covers CACHE_EXTRA_INPUTS: GL007/GL008 read const.py /
        # pyproject.toml, so a flag or marker deleted THERE must invalidate
        # every file's cached result, not just the program layer.
        return sha1 + "|" + ",".join(sorted(check_ids)) + "|" + extras_sha

    def get_file(self, relpath: str, key: str) -> Optional[dict]:
        entry = self._data["files"].get(relpath)
        if entry is not None and entry.get("key") == key:
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def put_file(self, relpath: str, key: str,
                 findings: Sequence[Finding],
                 suppressed: Sequence[Tuple[Finding, str]]):
        self._data["files"][relpath] = {
            "key": key,
            "findings": [f.to_json() for f in findings],
            "suppressed": [[f.to_json(), r] for f, r in suppressed]}
        self._dirty = True

    PROGRAM_SLOTS = 8   # full run, --changed-only, a few --check subsets

    def get_program(self, key: str) -> Optional[dict]:
        slots = self._data["program"]
        entry = slots.get(key) if isinstance(slots, dict) else None
        if entry is not None:
            self.program_hit = True
            # Refresh recency (insertion order IS the eviction order): the
            # hot full-run entry must outlive a burst of --changed-only
            # keys, not be evicted as the oldest insertion.
            slots.pop(key)
            slots[key] = entry
            self._dirty = True
        return entry

    def put_program(self, key: str, files_checked: int,
                    findings: Sequence[Finding],
                    suppressed: Sequence[Tuple[Finding, str]]):
        # Multi-slot: a --changed-only or --check run must not evict the
        # full run's warm entry (dict insertion order = LRU-ish eviction).
        slots = self._data["program"]
        if not isinstance(slots, dict) or "key" in slots:
            slots = {}
        slots.pop(key, None)
        slots[key] = {
            "files_checked": files_checked,
            "findings": [f.to_json() for f in findings],
            "suppressed": [[f.to_json(), r] for f, r in suppressed]}
        while len(slots) > self.PROGRAM_SLOTS:
            slots.pop(next(iter(slots)))
        self._data["program"] = slots
        self._dirty = True

    def prune_files(self, root: str):
        """Drop per-file entries whose source no longer exists (renames,
        deletions, CLI runs against temp fixtures) — the growth bound."""
        for rel in list(self._data["files"]):
            if not os.path.isfile(os.path.join(root, *rel.split("/"))):
                del self._data["files"][rel]
                self._dirty = True

    def save(self):
        if not self._dirty:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._data, f)
            os.replace(tmp, self.path)   # atomic: parallel shards last-win
        except OSError:
            pass   # a cache that cannot write is a slow cache, not an error

    def stats(self) -> Dict[str, object]:
        return {"enabled": True, "program_hit": self.program_hit,
                "file_hits": self.hits, "file_misses": self.misses}


# ------------------------------------------------------------------- the run

def _sha1(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


def _triage(raw: List[Finding], suppressed, baseline: Set[str],
            files: int, t0: float, cache_info) -> LintResult:
    # GL000 never matches the baseline: grandfathering a malformed/reasonless
    # directive would defeat the "GL000 cannot be suppressed" invariant
    # through the --write-baseline side door.
    new = [f for f in raw
           if f.check == META_CHECK or f.fingerprint not in baseline]
    grandfathered = [f for f in raw
                     if f.check != META_CHECK and f.fingerprint in baseline]
    stale = sorted(baseline - {f.fingerprint for f in raw})
    order = lambda f: (f.path, f.line, f.col, f.check)  # noqa: E731
    return LintResult(findings=sorted(new, key=order),
                      suppressed=suppressed,
                      baselined=sorted(grandfathered, key=order),
                      stale_baseline=stale,
                      files_checked=files,
                      wall_time_s=round(time.perf_counter() - t0, 4),
                      cache_info=cache_info)


def lint_paths(paths: Sequence[str], root: Optional[str] = None,
               baseline: Optional[Set[str]] = None,
               checks: Optional[Sequence[str]] = None,
               context: Optional[Context] = None,
               cache: Optional[LintCache] = None,
               skip_full_program: bool = False) -> LintResult:
    """Run the registry over ``paths``; returns the triaged result.

    ``baseline`` is a fingerprint set (see :func:`load_baseline`); matching
    findings are reported separately and do not fail the run. ``checks``
    restricts to a subset of check ids (fixture tests). ``cache`` enables
    the :class:`LintCache` layers; ``skip_full_program`` drops the checks
    only sound over the complete path set (the ``--changed-only`` mode)."""
    t0 = time.perf_counter()
    root = os.path.abspath(root or os.getcwd())
    ctx = context or Context(root)
    registry = all_checks()
    selected = [registry[c] for c in checks] if checks \
        else list(registry.values())
    if skip_full_program:
        selected = [c for c in selected if not c.full_program]
    module_checks = [c for c in selected if not c.program]
    program_checks = [c for c in selected if c.program]
    baseline = baseline or set()

    # Phase 0: read + hash every file (the warm path's whole cost).
    entries = []      # (abspath, relpath, source|None, read_error|None)
    for path in iter_py_files(paths, root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, "rb") as f:
                data = f.read()
            source = data.decode("utf-8")
            entries.append((path, rel, source, _sha1(data), None))
        except (OSError, UnicodeDecodeError) as e:
            entries.append((path, rel, None, "", Finding(
                META_CHECK, rel, 1, 0, f"unreadable file: {e}")))

    prog_key = None
    extras_sha = ""
    if cache is not None:
        def _inputs_sha(inputs):
            he = hashlib.sha1()
            for extra in inputs:
                p = os.path.join(root, *extra.split("/"))
                try:
                    with open(p, "rb") as f:
                        he.update(_sha1(f.read()).encode())
                except OSError:
                    pass   # absent/unreadable: hashed as missing; a
                    #        transient failure costs one miss, never the run
            return he.hexdigest()

        extras_sha = _inputs_sha(CACHE_MODULE_INPUTS)
        h = hashlib.sha1(checks_version().encode())
        for _, rel, _, sha, _ in entries:
            h.update(f"{rel}:{sha};".encode())
        h.update(",".join(sorted(c.id for c in selected)).encode())
        h.update(extras_sha.encode())
        h.update(_inputs_sha(CACHE_PROGRAM_INPUTS).encode())
        prog_key = h.hexdigest()
        hit = cache.get_program(prog_key)
        if hit is not None:
            raw = [_finding_from_json(d) for d in hit["findings"]]
            supp = [(_finding_from_json(d), r) for d, r in hit["suppressed"]]
            cache.save()   # persist the hit's recency refresh (LRU order)
            return _triage(raw, supp, baseline, hit["files_checked"], t0,
                           cache.stats())

    # Phase 1: parse + directives + per-module checks (file-cacheable).
    raw: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    modules: Dict[str, Module] = {}
    module_check_ids = [c.id for c in module_checks]
    for path, rel, source, sha, err in entries:
        if err is not None:
            raw.append(err)
            continue
        mod = Module(path, rel, source)
        raw.extend(mod.directive_findings)
        if mod.parse_error is not None:
            raw.append(mod.parse_error)
            continue
        modules[rel] = mod
        if cache is not None:
            key = LintCache.file_key(sha, module_check_ids, extras_sha)
            entry = cache.get_file(rel, key)
            if entry is not None:
                raw.extend(_finding_from_json(d) for d in entry["findings"])
                suppressed.extend((_finding_from_json(d), r)
                                  for d, r in entry["suppressed"])
                continue
        file_raw: List[Finding] = []
        file_supp: List[Tuple[Finding, str]] = []
        for check in module_checks:
            for finding in check.fn(mod, ctx):
                reason = mod.suppression_for(finding)
                if reason is not None:
                    file_supp.append((finding, reason))
                else:
                    file_raw.append(finding)
        raw.extend(file_raw)
        suppressed.extend(file_supp)
        if cache is not None:
            cache.put_file(
                rel, LintCache.file_key(sha, module_check_ids, extras_sha),
                file_raw, file_supp)

    # Phase 2: whole-program checks over the parsed set.
    if program_checks and modules:
        from autodist_tpu_torch.analysis.program import ProgramIndex
        ctx.program = ProgramIndex(modules)
        for check in program_checks:
            for finding in check.fn(ctx.program, ctx):
                mod = modules.get(finding.path)
                reason = mod.suppression_for(finding) \
                    if mod is not None else None
                if reason is not None:
                    suppressed.append((finding, reason))
                else:
                    raw.append(finding)

    if cache is not None and prog_key is not None:
        cache.put_program(prog_key, len(entries), raw, suppressed)
        cache.prune_files(root)
        cache.save()
    cache_info = cache.stats() if cache is not None else None
    return _triage(raw, suppressed, baseline, len(entries), t0, cache_info)
