"""AdamW and the gradient of a loss over a parameter tree (the JAX
package's ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,  # noqa: F401
                                     constant_schedule, cosine_schedule,
                                     global_norm, init_state,
                                     value_and_grad)
