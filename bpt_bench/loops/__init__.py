"""The general generators a traffic mix names by its ``loop``."""
