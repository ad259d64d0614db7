"""The LM substrate's synthetic token pipeline."""
