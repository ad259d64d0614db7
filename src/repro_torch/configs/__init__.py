"""Architecture configurations of the LM substrate, as data (a copy of the
reference's ``configs/``); ``configs.registry`` resolves ``--arch``."""
