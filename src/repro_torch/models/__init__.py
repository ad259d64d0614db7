"""LM substrate of the port (the reference's ``models/``): the dense GQA
family so far."""
