from .optimizer import (Optimizer, OptimizerOp, SGDOptimizer,
                        MomentumOptimizer, AdamOptimizer, AdamWOptimizer)
from .lr_scheduler import (LRScheduler, FixedScheduler, StepScheduler,
                           MultiStepScheduler, ExponentialScheduler,
                           CosineScheduler, LinearWarmupScheduler,
                           as_schedule)
