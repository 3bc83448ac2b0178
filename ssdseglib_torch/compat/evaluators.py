"""Alias of `ssdseglib_torch.evaluators` under the reference module name, the
port's counterpart of ssdseglib/evaluators.py.

The reference notebooks address this module as `ssdseglib.evaluators`
(reference ssdseglib/__init__.py:1-9); every implementation lives in
`ssdseglib_torch.evaluators` -- this file only mirrors its namespace.
"""

import ssdseglib_torch.evaluators as _impl

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)
del _impl
