"""The documentation corpus the doc-driven datasets read (counterpart
of ``mlapi_tpu/datasets/_corpus.py``).

``docs_text`` reads four prose files of the repository. By default it
reads the commit-pinned snapshot in ``docs_corpus/`` (a byte-identical
copy of the JAX package's snapshot; its ``MANIFEST.json`` records each
file's sha256), so its numbers reproduce from a clean checkout while
the live docs grow. This module is the one place that knows the file
list, the snapshot location, the flat-vs-repository layout fallback
and the provenance string.
"""

from __future__ import annotations

from pathlib import Path

# The corpus files, in repository layout. The frozen snapshot stores
# each at the top level (flat); resolve_doc() tries both.
DOC_SOURCES = (
    "README.md",
    "SURVEY.md",
    "BASELINE.md",
    "docs/DESIGN.md",
)


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def frozen_corpus() -> Path:
    """The commit-pinned snapshot directory (provenance and sha256s in
    its ``MANIFEST.json``)."""
    return Path(__file__).resolve().parent / "docs_corpus"


def resolve_root(root: str | None) -> Path:
    """``None`` → the frozen snapshot; ``"live"`` → the repository's
    current docs; anything else → a user directory holding the corpus
    files (flat or repository layout)."""
    if root is None:
        return frozen_corpus()
    if root == "live":
        return repo_root()
    return Path(root)


def resolve_doc(base: Path, rel: str) -> Path | None:
    """One corpus file under ``base``: repository layout first, then the
    flat layout of the snapshot; ``None`` when absent."""
    p = base / rel
    if p.exists():
        return p
    flat = base / Path(rel).name
    if flat.exists():
        return flat
    return None


def live_markdown_docs(base: Path) -> list[Path]:
    """Every ``docs/*.md`` under ``base`` beyond ``DOC_SOURCES``, sorted
    by name: the live corpus follows the documentation as it grows."""
    known = {Path(rel).name for rel in DOC_SOURCES}
    return sorted(
        p for p in (base / "docs").glob("*.md") if p.name not in known
    )


def corpus_provenance(base: Path) -> str:
    """The provenance string a run carries in ``extras["corpus"]``: the
    frozen snapshot reports its pinned commit, anything else the path
    it read.

    A frozen claim is verified: the manifest must cover exactly the
    ``DOC_SOURCES`` basenames (any other directory with a manifest is a
    user corpus and reports ``live:<path>``), and every file must hash
    to its recorded sha256, else this raises: a corrupted snapshot must
    not pass as the pinned one."""
    mf = base / "MANIFEST.json"
    if not mf.exists():
        return f"live:{base}"
    import hashlib
    import json

    manifest = json.loads(mf.read_text())
    files = manifest.get("files", {})
    if set(files) != {Path(rel).name for rel in DOC_SOURCES}:
        return f"live:{base}"
    for name, meta in files.items():
        p = base / name
        digest = (
            hashlib.sha256(p.read_bytes()).hexdigest()
            if p.exists() else "<missing>"
        )
        if digest != meta.get("sha256"):
            raise ValueError(
                f"frozen corpus snapshot is corrupted: {name} hashes "
                f"to {digest[:12]}…, MANIFEST.json records "
                f"{str(meta.get('sha256'))[:12]}… — restore "
                f"datasets/docs_corpus/ from git before trusting any "
                f"measurement"
            )
    commit = manifest.get("source_commit", "?")
    return f"frozen@{commit}"
