"""The plain reference: the deployments' graphs, the RNG contract's draws,
a plain IC sampler and plain query answers.  Imports nothing of the
program."""
