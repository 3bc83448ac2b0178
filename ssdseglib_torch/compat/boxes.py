"""Alias of `ssdseglib_torch.boxes` under the reference module name, the
port's counterpart of ssdseglib/boxes.py.

The reference notebooks address this module as `ssdseglib.boxes`
(reference ssdseglib/__init__.py:1-9); every implementation lives in
`ssdseglib_torch.boxes` -- this file only mirrors its namespace.
"""

import ssdseglib_torch.boxes as _impl

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)
del _impl
