"""The `davisinteractive` toolkit's API over the port's protocol stack:
the PyTorch port of the repository's top-level `davisinteractive/` shim.

Code written against the external toolkit, as upstream MANet's eval
script is, runs on the port with one change, the import prefix:

    from cvpr2020_manet_tpu_torch.davisinteractive.session import (
        DavisInteractiveSession)
    from cvpr2020_manet_tpu_torch.davisinteractive.utils.scribbles import (
        scribbles2mask, annotated_frames)

It is a thin adapter over `cvpr2020_manet_tpu_torch.interactive.*`,
`utils/colormap.py`, `utils/visualize.py` and `native/image.py`: it
translates upstream argument names and orders (upstream metrics take
`(y_true, y_pred)`, the port's `(pred, gt, num_objects)`) and delegates
the rest. It imports no pandas (reports are lists of row dicts) and no
PIL (JPEGs go through the port's decoder).

It does not register itself as `davisinteractive` in `sys.modules`, so a
process may hold it beside the JAX-backed shim. It is not the upstream
package: `__is_manet_tpu_shim__` marks it.
"""

from cvpr2020_manet_tpu_torch.davisinteractive.session import (
    DavisInteractiveSession)

__version__ = "0.0.0+manet-tpu-shim"
__is_manet_tpu_shim__ = True

__all__ = ["DavisInteractiveSession", "__version__",
           "__is_manet_tpu_shim__"]
