"""The benchmark's machinery shared by its drivers and metric readers."""
