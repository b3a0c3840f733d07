"""Optional remote experiment tracking (counterpart of
``confignet_tpu/core/remote_logging.py``; reference:
confignet/azure_ml_utils.py): the AzureML run context inside an AML job,
else None, and helpers that log to it when there is one."""
from __future__ import annotations


def get_aml_run():
    """The AzureML Run context when available, else None
    (reference: azure_ml_utils.py:8-14)."""
    try:
        from azureml.core.run import Run  # type: ignore
    except ImportError:
        return None
    run = Run.get_context()
    if type(run).__name__ == "_OfflineRun":
        return None
    return run


def log_job_params(aml_run, args) -> None:
    if aml_run is None:
        return
    for name, value in vars(args).items():
        aml_run.log(name, value)


def log_losses(aml_run, loss_names, loss_vals, prefix: str = "") -> None:
    if aml_run is None:
        return
    for name, value in zip(loss_names, loss_vals):
        aml_run.log(prefix + name, float(value))
