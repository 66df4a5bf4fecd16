"""Config documentation harvesting (a copy of ``xicsrt_tpu/utils/docs.py``).

Equivalent of the reference's ``@dochelper`` (``xicsrt/tools/xicsrt_doc.py``):
each element class documents its config options in the ``default_config``
docstring; this module walks the MRO and assembles the combined
"Configuration Options" section for a class, and can append it to the class
docstring.
"""

from __future__ import annotations

import textwrap


def harvest_config_docs(cls) -> list:
    """[(class_name, doc_text)] for every default_config docstring in the MRO,
    most-derived first."""
    out = []
    for klass in cls.__mro__:
        fn = klass.__dict__.get("default_config")
        doc = getattr(fn, "__doc__", None)
        if doc:
            text = textwrap.dedent(doc).strip()
            if text:
                out.append((klass.__name__, text))
    return out


def config_doc(cls) -> str:
    """The combined configuration-options section for an element class."""
    sections = harvest_config_docs(cls)
    if not sections:
        return ""
    parts = ["Configuration Options", "---------------------"]
    for name, text in sections:
        parts.append(f"[from {name}]")
        parts.append(text)
        parts.append("")
    return "\n".join(parts).rstrip()


def attach_config_doc(cls):
    """Append the combined config docs to the class docstring (dochelper)."""
    doc = config_doc(cls)
    if doc:
        base = textwrap.dedent(cls.__doc__ or "").rstrip()
        cls.__doc__ = f"{base}\n\n{doc}\n" if base else doc
    return cls


def describe(class_name: str) -> str:
    """Print + return the documentation of a registered element class."""
    from xicsrt_tpu_torch.dispatch import lookup

    cls = lookup(class_name)
    head = cls.__doc__ or ""
    body = config_doc(cls)
    text = f"{cls.__name__}\n{'=' * len(cls.__name__)}\n{head.strip()}\n\n{body}"
    print(text)
    return text
