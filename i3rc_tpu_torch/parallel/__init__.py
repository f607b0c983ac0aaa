"""Batches over torch.distributed ranks, checkpoint and resume, and the
x-sharded domain tracer (the MultipleProcesses analog)."""
