from fira_tpu_torch.eval.bnorm_bleu import bnorm_bleu, bnorm_bleu_files
from fira_tpu_torch.eval.penalty_bleu import penalty_bleu, penalty_bleu_files
from fira_tpu_torch.eval.rouge import rouge_l, rouge_l_files
from fira_tpu_torch.eval.meteor import meteor, meteor_files
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu, sentence_bleu_method2

__all__ = [
    "bnorm_bleu",
    "bnorm_bleu_files",
    "penalty_bleu",
    "penalty_bleu_files",
    "rouge_l",
    "rouge_l_files",
    "meteor",
    "meteor_files",
    "nltk_sentence_bleu",
    "sentence_bleu_method2",
]
