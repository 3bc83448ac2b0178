"""Alias of `ssdseglib_torch.plot` under the reference module name, the
port's counterpart of ssdseglib/plot.py.

The reference notebooks address this module as `ssdseglib.plot`
(reference ssdseglib/__init__.py:1-9); every implementation lives in
`ssdseglib_torch.plot` -- this file only mirrors its namespace.
"""

import ssdseglib_torch.plot as _impl

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)
del _impl
