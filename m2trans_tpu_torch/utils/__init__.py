"""Experiment utilities and the complexity report of the port."""

from m2trans_tpu_torch.utils.experiment import (  # noqa: F401
    ExperimentLogger,
    cur_timestamp_str,
    get_stat_dict,
    setup_experiment,
)
from m2trans_tpu_torch.utils.flops import (  # noqa: F401
    model_complexity_report,
    model_flops,
)
