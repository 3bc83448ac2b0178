"""Alias of `ssdseglib_torch.layers` under the reference module name, the
port's counterpart of ssdseglib/layers.py.

The reference notebooks address this module as `ssdseglib.layers`
(reference ssdseglib/__init__.py:1-9); every implementation lives in
`ssdseglib_torch.layers` -- this file only mirrors its namespace.
"""

import ssdseglib_torch.layers as _impl

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)
del _impl
