"""Kernel names as a profiler gives them, shortened to the kernel's own
name (ptdn_tpu_torch/utils/card.py:kernel_name for a mangled name)."""

from __future__ import annotations

import re


def kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled entry name: the
    length-prefixed identifier that ends in _kernel."""
    for m in re.finditer(r"(?=([0-9]+))", mangled):   # every digit suffix
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
            return name
    return mangled


def short_name(name: str) -> str:
    """A kernel's own name: kernel_name's for a mangled name, else the
    function's unqualified name in a demangled one ('void
    at::native::(anonymous namespace)::f<4, ...>(...)' -> 'f')."""
    if name.startswith("_Z"):
        return kernel_name(name)
    head = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].strip()
    head = head.split(" ")[-1]
    return head.split("::")[-1] or name
