"""The LM substrate's training: the step, the fault-tolerant loop and the
data-parallel step."""
