"""Optimizers, gradient clipping and learning-rate schedules
(``repro.optim``), on the flat parameter dicts ``models.common``
defines.

The state dicts have ``repro``'s keys (``step``, ``master``, ``mu`` /
``nu`` or ``v``), so a checkpoint written by either package and
``convert.opt_state_from_state`` map one package's state onto the
other's.  The updates work in place, one parameter at a time, in f32 (or
wider), in ``repro``'s order of operations.  ZeRO-1:
``opt_state_pspecs`` and ``adafactor_state_pspecs`` give ``repro``'s
state specs; on a mesh the updates take each gradient to its state's
placements and write each parameter back to its own.
"""

from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "cosine_schedule", "linear_warmup",
           "global_norm", "clip_by_global_norm"]
