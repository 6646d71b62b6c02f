"""ADD / ADD-S evaluation."""
