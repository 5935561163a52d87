from .anomaly import (AnomalyReport, auc, average_precision,
                      confusion_at_threshold, evaluate_detector,
                      precision_recall_curve, reconstruction_errors,
                      roc_curve)

__all__ = ["reconstruction_errors", "confusion_at_threshold", "roc_curve",
           "auc", "precision_recall_curve", "average_precision",
           "evaluate_detector", "AnomalyReport"]
