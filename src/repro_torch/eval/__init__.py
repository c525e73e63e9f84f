"""Evaluation engines: BMA metrics over a posterior bank, and the
scenario matrix (``eval.matrix``)."""
from repro_torch.eval.engine import (EvalAccum, EvalReport, HostEvalEngine,
                                     ScanEvalEngine, ShardEvalEngine,
                                     abstain_mask, as_stacked, finalize,
                                     init_accum, make_eval_engine,
                                     stack_eval_batches, update_accum)

__all__ = [
    "EvalAccum", "EvalReport", "HostEvalEngine", "ScanEvalEngine",
    "ShardEvalEngine", "abstain_mask", "as_stacked", "finalize",
    "init_accum", "make_eval_engine", "stack_eval_batches", "update_accum",
]
