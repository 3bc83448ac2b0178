"""Alias of `ssdseglib_torch.blocks` under the reference module name, the
port's counterpart of ssdseglib/blocks.py.

The reference notebooks address this module as `ssdseglib.blocks`
(reference ssdseglib/__init__.py:1-9); every implementation lives in
`ssdseglib_torch.blocks` -- this file only mirrors its namespace.
"""

import ssdseglib_torch.blocks as _impl

globals().update(
    {k: v for k, v in vars(_impl).items() if not k.startswith("__")}
)
del _impl
