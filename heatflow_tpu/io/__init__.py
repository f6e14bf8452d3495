from heatflow_tpu.io.csvio import (write_watcher_csv, write_gradient_csv,
                                   read_gradient_csv)

__all__ = [
    "write_watcher_csv",
    "write_gradient_csv",
    "read_gradient_csv",
    "XDMFTimeSeriesWriter",
    "read_xdmf_timeseries",
]


def __getattr__(name):
    # XDMF output needs h5py, an optional dependency: import it only when
    # XDMF is asked for (heatflow_tpu.io.xdmfio raises a clear error)
    if name in ("XDMFTimeSeriesWriter", "read_xdmf_timeseries"):
        from heatflow_tpu.io import xdmfio
        return getattr(xdmfio, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
