"""`davisinteractive.session`: the port's `DavisInteractiveSession`
(`interactive/session.py`), whose constructor has the upstream signature
(`host`, `key`, `davis_root`, `subset`, `max_nb_interactions`,
`max_time`, `metric_to_optimize`). An `http(s)://` host returns a
session of the remote evaluation service; any other host runs the
in-process local service. `get_report()` returns a list of row dicts
(`interactive.session.write_report_csv` writes it as CSV)."""

from cvpr2020_manet_tpu_torch.interactive.session import (
    DavisInteractiveSession)

__all__ = ["DavisInteractiveSession"]
