"""Host-side core shared by the serving planes."""
